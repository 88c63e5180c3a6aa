"""The port's engine on a mesh: spawned gloo groups of CPU processes
(tests/torch_mesh_workers.py, one torch thread each), on the tiny float32
weights of a JAX engine, against the port's one-process engine and the JAX
engine under its 8-device conftest mesh (the cases of
tests/test_engine_mesh.py and __graft_entry__.dryrun_multichip's train step).

Three spawns: tp = 2 on 2 ranks, dp = 2 x tp = 2 on 4 ranks, and the web
server on tp = 2. Greedy codes must equal token for token; slot-mode wavs
within 2 int16 units of the engine's solo infer; int8-weight logits within
1e-4; vocoder rows within 1e-5; the training step's loss and updated
parameters within 1e-4 of jax.value_and_grad; the server's wav within 2
int16 units of a one-process server's."""

import os
import pickle
import socket
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from indextts_tpu.config import save_config
from indextts_tpu.engine import IndexTTS as JaxIndexTTS
from indextts_tpu.models.gpt import unified_voice_forward as jax_forward
from indextts_tpu.models.gpt_decode import GenerationConfig as JaxGen
from indextts_tpu.parallel.mesh import shard_gpt_params as jax_shard
from indextts_tpu_torch.convert import save_params_npz
from indextts_tpu_torch.models.gpt import UnifiedVoice
from indextts_tpu_torch.ops.quant import quantize_unified_voice
from indextts_tpu_torch.server.webui import create_app
from indextts_tpu_torch.weights import load_jax_params
from tests import torch_mesh_workers as w
from tests.test_engine import tiny_config
from tests.test_torch_vocoder import scramble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(kind: str, world: int, spec, out_dir: str):
    """Run `kind`'s group on `world` ranks; every rank must exit 0 within
    SPAWN_TIMEOUT (a hang is killed and fails). Returns each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(w.run, args=(world, _free_port(), kind, spec, out_dir), nprocs=world,
                                                join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the {kind} group did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    for r, res in enumerate(results):
        assert res["ok"], f"rank {r}: {res.get('error')}"
    return results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX engine (its mel head sharpened and the vocoder scrambled, as
    tests/test_torch_infer_fast.py does, so that greedy runs several codes
    and the wav is audible), its weights written as the port's .npz caches,
    the JAX mesh engine (tp = 2) on the same weights, the port's one-process
    engine, and the inputs every rank gets."""
    d = tmp_path_factory.mktemp("mesh_ckpt")
    cfg_path = str(d / "config.yaml")
    save_config(tiny_config(), cfg_path)
    je = JaxIndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, allow_random_init=True, use_mesh=False)
    rng = np.random.default_rng(31)
    je.gpt_params["mel_head"]["weight"] = jnp.asarray(
        rng.standard_normal(je.gpt_params["mel_head"]["weight"].shape).astype(np.float32) * 0.3)
    je.bigvgan_params = jax.tree_util.tree_map(
        jnp.asarray, scramble(jax.tree_util.tree_map(np.asarray, je.bigvgan_params), rng))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    save_params_npz(np_tree(je.gpt_params), str(d / "gpt.pth.npz"))
    save_params_npz(np_tree(je.bigvgan_params), str(d / "bigvgan_generator.pth.npz"))
    jm = JaxIndexTTS(cfg_path=cfg_path, model_dir=str(d), is_fp16=False, allow_random_init=True, use_mesh=True, tp=2)
    jm.gpt_params = jax_shard(je.gpt_params, jm.mesh)

    gcfg = tiny_config().gpt
    r = np.random.default_rng(0)
    lat_rows = r.standard_normal((4, 32, gcfg.model_dim)).astype(np.float32)
    spec = {
        "cfg": cfg_path, "dir": str(d), "prompt_wav": os.path.join(REPO, "tests", "sample_prompt.wav"),
        "mel": r.standard_normal((1, 100, 60)).astype(np.float32),
        "tokens4": r.integers(2, 40, (4, 9)).astype(np.int64), "lens4": np.asarray([9, 7, 8, 6]),
        "tokens5": r.integers(2, 40, (5, 9)).astype(np.int64), "lens5": np.asarray([9, 7, 9, 5, 8]),
        "forced": r.integers(0, gcfg.start_mel_token, (4, 4)),
        "vocoder": {"latent": lat_rows, "mel_ref": r.standard_normal((4, 100, 100)).astype(np.float32),
                    "rel": np.asarray([0.6, 1.0, 0.8, 0.6], np.float32)},
        "train": {"mel": r.standard_normal((4, 64, 100)).astype(np.float32),
                  "mel_lens": np.asarray([64, 60, 64, 50]),
                  "text": r.integers(2, 50, (4, 12)).astype(np.int64), "text_lens": np.asarray([12, 9, 12, 7]),
                  "codes": r.integers(0, 60, (4, 20)).astype(np.int64),
                  "wav_lens": np.asarray([20, 17, 20, 12]) * gcfg.mel_length_compression},
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    single = w.engine(spec, False)
    assert single.mesh is None
    yield {"spec": spec, "je": je, "jm": jm, "single": single, "tmp": tmp_path_factory}
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp_run(world):
    return _spawn("tp", 2, world["spec"], str(world["tmp"].mktemp("tp_run")))


@pytest.fixture(scope="module")
def dp_run(world):
    return _spawn("dp", 4, world["spec"], str(world["tmp"].mktemp("dp_run")))


def _jax_codes(engine, spec, rows):
    gen = JaxGen(do_sample=False, num_beams=1, max_new_tokens=w.GREEDY.max_new_tokens)
    codes, lens, _ = engine._gpt_generate(engine._conds_for(spec["mel"]), spec["tokens" + rows].astype(np.int32),
                                          spec["lens" + rows].astype(np.int32), gen, 1.0, 0.8, 1.0)
    return np.asarray(codes), np.asarray(lens)


def _same_codes(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# tp = 2
# ---------------------------------------------------------------------------


def test_tp_layout(tp_run):
    """Each rank holds 2 of the 4 heads and 33 of the 66 mel codes; the odd
    text vocabulary (51) stays whole."""
    for r, res in enumerate(tp_run):
        assert res["shape"] == {"data": 1, "model": 2} and res["coords"] == (0, r)
        assert res["heads"] == 2 and res["mel_head_rows"] == 33 and res["text_head_rows"] == 51


def test_tp_greedy_codes_match_one_process_and_jax(world, tp_run):
    spec = world["spec"]
    want = w.decode(world["single"], spec, "4", w.GREEDY)
    assert want[1].max() > 3  # several codes before the stop
    _same_codes(want, _jax_codes(world["jm"], spec, "4"))
    _same_codes(want, _jax_codes(world["je"], spec, "4"))
    for res in tp_run:
        _same_codes(res["greedy4"], want)


def test_tp_sampled_tokens_equal_across_ranks(world, tp_run):
    """Both ranks of the model group hold the same logits and draw from the
    same generator state: the same tokens, which are also one process's."""
    _same_codes(tp_run[0]["sampled4"], tp_run[1]["sampled4"])
    _same_codes(tp_run[0]["sampled4"], w.decode(world["single"], world["spec"], "4", w.SAMPLED, w.SAMPLED_KNOBS,
                                                seed=7))


def test_tp_slot_mode_matches_solo(tp_run):
    for res in tp_run:
        for (sr_s, wav_s), (sr_o, wav_o) in zip(res["solo"], res["slots"]):
            assert sr_s == sr_o == 24000 and wav_s.shape == wav_o.shape and wav_s.shape[0] > 0
            assert np.abs(wav_s.astype(np.int32) - wav_o.astype(np.int32)).max() <= 2
    np.testing.assert_array_equal(tp_run[0]["slots"][0][1], tp_run[1]["slots"][0][1])


def test_tp_int8_weights(world, tp_run):
    """Quantizing the shards equals quantizing the whole model and then
    sharding it; the row-parallel int8 weights hold half the input; forced
    logits through K5's plain version within 1e-4 of one process on int8
    weights."""
    single = w.engine(world["spec"], False)
    quantize_unified_voice(single.gpt)
    want = w.forced_logits(single, world["spec"])
    d = tiny_config().gpt.model_dim
    for res in tp_run:
        assert res["int8_orders_equal"] and res["int8_modules"] == 4 * tiny_config().gpt.layers + 1
        shapes = res["int8_shapes"]
        assert shapes["gpt.blocks.0.attn_qkv.weight"] == (3 * d // 2, d)
        assert shapes["gpt.blocks.0.attn_proj.weight"] == (d, d // 2)
        assert shapes["gpt.blocks.0.mlp_proj.weight"] == (d, 2 * d)
        assert shapes["mel_head.weight"] == (33, d)
        assert res["int8_logits"].shape == want.shape
        np.testing.assert_allclose(res["int8_logits"], want, atol=1e-4, rtol=0)


def test_ranks_that_disagree_raise_everywhere(tp_run):
    """Rank 1 got other text: every rank raises at the request's check
    instead of waiting in a collective."""
    for res in tp_run:
        assert res["disagree"] is not None and "different requests" in res["disagree"]
        assert res["disagree_s"] < 30


# ---------------------------------------------------------------------------
# dp = 2 x tp = 2
# ---------------------------------------------------------------------------


def test_dp_layout(dp_run):
    assert [res["coords"] for res in dp_run] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(res["shape"] == {"data": 2, "model": 2} for res in dp_run)


def test_dp_greedy_codes_match_one_process_and_jax(world, dp_run):
    want = w.decode(world["single"], world["spec"], "4", w.GREEDY)
    _same_codes(want, _jax_codes(world["jm"], world["spec"], "4"))
    for res in dp_run:
        _same_codes(res["greedy4"], want)


def test_dp_non_divisible_batch(world, dp_run):
    """5 rows on 2 data groups pad to 6 and slice back to 5."""
    want = w.decode(world["single"], world["spec"], "5", w.GREEDY)
    _same_codes(want, _jax_codes(world["jm"], world["spec"], "5"))
    for res in dp_run:
        assert res["greedy5"][0].shape[0] == 5
        _same_codes(res["greedy5"], want)


def test_dp_int8_kv_beams(world, dp_run):
    single = w.engine(world["spec"], False, quant_kv=True)
    want = w.decode(single, world["spec"], "4", w.BEAMS)
    for res in dp_run:
        _same_codes(res["beams_int8_kv"], want)


def test_dp_sampled_codes_match_one_process(world, dp_run):
    """Each data group draws the whole batch's uniforms and keeps its rows,
    and the generator state of the group that ran longest goes to every
    rank: the codes and the state after them are one process's."""
    single = world["single"]
    want = w.decode(single, world["spec"], "4", w.SAMPLED, w.SAMPLED_KNOBS, seed=7)
    state = single._generator.get_state().numpy()
    for res in dp_run:
        _same_codes(res["sampled4"], want)
        np.testing.assert_array_equal(res["generator_state"], state)


def test_dp_vocoder(world, dp_run):
    single = world["single"]
    with torch.no_grad():
        want_rows = single._vocode_rows(*w.vocoder_inputs(single, world["spec"])).numpy()
        want_many = single._vocode_many(w.vocoder_chunks(world["spec"]))
    for res in dp_run:
        np.testing.assert_allclose(res["vocode_rows"], want_rows, atol=1e-5, rtol=0)
        assert len(res["vocode_many"]) == 3
        for got, want in zip(res["vocode_many"], want_many):
            assert got.shape == want.shape and got.dtype == np.int16
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_tp_dp_training_step_matches_jax(world, dp_run):
    """__graft_entry__.dryrun_multichip's step (text + mel cross-entropy,
    the gradient, SGD at 1e-4) at dp = 2 x tp = 2 against jax.value_and_grad
    of JAX's unified_voice_forward on the unsharded tree: the loss and the
    updated parameters, gathered, within 1e-4; and the update itself (the
    gradient) within 1e-3 of JAX's."""
    cfg = tiny_config().gpt
    batch = {k: jnp.asarray(v) for k, v in world["spec"]["train"].items()}
    params = world["je"].gpt_params

    def loss_fn(p):
        lt, lm, _ = jax_forward(p, cfg, batch["mel"], batch["text"], batch["text_lens"], batch["codes"],
                                batch["wav_lens"], batch["mel_lens"], return_latent=False)
        return lt + lm

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new = jax.tree_util.tree_map(lambda p, g: p - w.LR * g, params, grads)
    ref_new, ref_old = UnifiedVoice(cfg), UnifiedVoice(cfg)
    load_jax_params(ref_new, new)
    load_jax_params(ref_old, params)
    want, old = ref_new.state_dict(), ref_old.state_dict()
    for res in dp_run:
        assert abs(res["train_loss"] - float(loss)) <= 1e-4, (res["train_loss"], float(loss))
        got = res["train_params"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), atol=1e-4, rtol=0, err_msg=k)
            step = (old[k].numpy() - got[k]) / w.LR
            np.testing.assert_allclose(step, (old[k] - v).numpy() / w.LR, atol=1e-3, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the web server
# ---------------------------------------------------------------------------


def test_two_rank_server_matches_one_process(world, tmp_path):
    """rank 0 serves /api/synthesize through the proxy while rank 1 replays
    its calls; both exit cleanly after stop. The wav is a one-process
    server's; a stream closed after its first chunk and a later request
    keep the ranks in step."""
    res = _spawn("server", 2, world["spec"], str(tmp_path / "server_run"))
    assert res[1] == {"ok": True, "followed": True}
    single = world["single"]
    app = create_app(single, base_dir=str(tmp_path / "www"))
    try:
        want = w.synthesize(app, str(tmp_path / "www"), world["spec"]["prompt_wav"])
    finally:
        app.shutdown()
    got = res[0]["wav"]
    assert got.shape == want.shape and want.shape[0] > 3 * single._samples_per_code()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
    assert res[0]["first_chunk"].size > 0 and res[0]["after_stream"][1].shape[0] > 0
