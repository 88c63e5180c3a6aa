"""The port's checkpoint loading against the JAX package's: convert.py's
converters leaf for leaf (exactly) on reference-format state dicts from
tests/make_torch_ckpt.py, in the legacy weight_g / weight_v form, the
parametrize form and bf16; the .npz cache read and written across the two
packages; and the engine's load order (.npz cache, .pth, random init,
FileNotFoundError) on one checkpoint directory, greedy codes equal to the JAX
engine's and the int16 wav within 8 units (as tests/test_checkpoint_loading.py
holds the JAX engine)."""

import os
import shutil

import numpy as np
import pytest
import torch

import indextts_tpu.convert as jconv
import indextts_tpu_torch.convert as tconv
from tests.make_torch_ckpt import write_checkpoints
from tests.test_engine import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "tests", "sample_prompt.wav")
WAV_TOL = 8
GREEDY = dict(text="HELLO WORLD. THIS IS A TEST.", do_sample=False, num_beams=1, max_mel_tokens=24,
              max_text_tokens_per_sentence=16)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ckpt"))
    write_checkpoints(tiny_config(), d)
    # one torch thread while these tests run (tests/test_torch_infer_fast.py:engines)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield d
    torch.set_num_threads(threads)


def _fresh_copy(src: str, dst: str) -> str:
    """The checkpoint directory without any .npz cache."""
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        if not f.endswith(".npz"):
            shutil.copy(os.path.join(src, f), dst)
    return dst


def assert_trees_equal(got, want, path=""):
    """Same structure (dict keys, list lengths), dtypes and values, exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


def _rewrite(sd: dict, form: str) -> dict:
    """A state dict in another of the forms real checkpoints come in."""
    if form == "parametrize":  # torch.nn.utils.parametrizations.weight_norm's names
        out = {}
        for k, v in sd.items():
            if k.endswith(".weight_g"):
                k = k[: -len("weight_g")] + "parametrizations.weight.original0"
            elif k.endswith(".weight_v"):
                k = k[: -len("weight_v")] + "parametrizations.weight.original1"
            out[k] = v
        return out
    if form == "bf16":
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in sd.items()}
    return sd


def _state_dicts(ckpt_dir, tmp_path, form):
    """The port's load of gpt.pth and bigvgan_generator.pth rewritten to
    `form` and saved again, after checking it equals the JAX package's load."""
    out = {}
    for name, key in (("gpt.pth", None), ("bigvgan_generator.pth", "generator")):
        obj = torch.load(os.path.join(ckpt_dir, name), map_location="cpu", weights_only=True)
        sd = _rewrite(obj[key] if key else obj, form)
        path = str(tmp_path / f"{form}_{name}")
        torch.save({key: sd} if key else sd, path)
        ours, theirs = tconv.load_torch_state_dict(path, key=key), jconv.load_torch_state_dict(path, key=key)
        assert_trees_equal(ours, theirs)
        if form == "bf16":
            assert all(v.dtype != np.float64 for v in ours.values())
            assert ours["mel_embedding.weight" if key is None else "conv_pre.bias"].dtype == np.float32
        out[name] = ours
    return out


@pytest.mark.parametrize("form", ["weight_v", "parametrize", "bf16"])
@pytest.mark.parametrize("which", ["unified_voice", "bigvgan", "ecapa"])
def test_converters_equal_jax(ckpt_dir, tmp_path, form, which):
    cfg = tiny_config()
    sds = _state_dicts(ckpt_dir, tmp_path, form)
    if which == "unified_voice":
        got, want = (m.convert_unified_voice(sds["gpt.pth"], cfg.gpt) for m in (tconv, jconv))
    elif which == "bigvgan":
        got, want = (m.convert_bigvgan(sds["bigvgan_generator.pth"], cfg.bigvgan) for m in (tconv, jconv))
    else:
        got, want = (m.convert_ecapa(sds["bigvgan_generator.pth"], "speaker_encoder") for m in (tconv, jconv))
    assert_trees_equal(got, want)


def test_converters_fold_both_weight_norm_forms_alike(ckpt_dir, tmp_path):
    """The parametrize form folds to the same weights as the legacy form."""
    cfg = tiny_config()
    legacy = _state_dicts(ckpt_dir, tmp_path, "weight_v")["bigvgan_generator.pth"]
    param = _state_dicts(ckpt_dir, tmp_path, "parametrize")["bigvgan_generator.pth"]
    assert any(".parametrizations.weight.original1" in k for k in param)
    assert_trees_equal(tconv.convert_bigvgan(param, cfg.bigvgan), tconv.convert_bigvgan(legacy, cfg.bigvgan))


def test_weight_norm_fold_equals_jax_and_torch():
    from indextts_tpu.ops.conv import weight_norm_fold as jfold
    from indextts_tpu_torch.ops.conv import weight_norm_fold

    rng = np.random.default_rng(3)
    v = rng.standard_normal((6, 5, 7)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, (6, 1, 1)).astype(np.float32)
    got = weight_norm_fold(v, g)
    np.testing.assert_array_equal(got, jfold(v, g))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, torch._weight_norm(torch.from_numpy(v), torch.from_numpy(g), 0).numpy(),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("which", ["gpt", "bigvgan"])
def test_npz_cache_is_shared(ckpt_dir, tmp_path, writer, which):
    """A cache written by either package loads in the other with equal
    leaves; the flat keys are the same, empty containers included."""
    cfg = tiny_config()
    if which == "gpt":
        tree = tconv.convert_unified_voice(tconv.load_torch_state_dict(os.path.join(ckpt_dir, "gpt.pth")), cfg.gpt)
    else:
        sd = tconv.load_torch_state_dict(os.path.join(ckpt_dir, "bigvgan_generator.pth"), key="generator")
        tree = tconv.convert_bigvgan(sd, cfg.bigvgan)
    tree["empty_list"], tree["empty_dict"] = [], {}
    assert sorted(tconv.flatten_tree(tree)) == sorted(jconv.flatten_tree(tree))
    save, load = (tconv.save_params_npz, jconv.load_params_npz) if writer == "port" else \
        (jconv.save_params_npz, tconv.load_params_npz)
    path = str(tmp_path / "cache.npz")
    save(tree, path)
    back = load(path)
    assert_trees_equal(back, tree)
    assert back["empty_list"] == [] and back["empty_dict"] == {}


@pytest.mark.parametrize("condition_type", ["perceiver", "default"])
def test_legacy_condition_types_raise(ckpt_dir, condition_type):
    """The legacy condition types convert (tests/test_torch_legacy_conditioning.py);
    a conformer_perceiver gpt.pth read as one of them lacks the
    AttentionBlock encoder and raises the JAX converter's KeyError."""
    cfg = tiny_config().gpt
    cfg.condition_type = condition_type
    sd = tconv.load_torch_state_dict(os.path.join(ckpt_dir, "gpt.pth"))
    with pytest.raises(KeyError, match="conditioning_encoder.init.weight"):
        jconv.convert_unified_voice(sd, cfg)
    with pytest.raises(KeyError, match="conditioning_encoder.init.weight"):
        tconv.convert_unified_voice(sd, cfg)


def _recording_infer(engine, **kw):
    codes = []
    generate = engine._gpt_generate

    def recording(*a, **k):
        out = generate(*a, **k)
        codes.append(np.asarray(out[0]))
        return out

    engine._gpt_generate = recording
    try:
        _, wav = engine.infer(audio_prompt=PROMPT, **kw)
    finally:
        del engine._gpt_generate
    return wav, codes


def test_engine_loads_checkpoint_directory_like_jax(ckpt_dir, tmp_path, capsys):
    """The port converts the .pth files and writes the caches; the JAX engine
    then reads the port's caches; a second port engine takes the cache path.
    Greedy codes equal, wav within 8 int16 units of JAX's and identical
    between the two port engines."""
    from indextts_tpu.engine import IndexTTS as JaxIndexTTS
    from indextts_tpu_torch.engine import IndexTTS

    d = _fresh_copy(ckpt_dir, str(tmp_path / "ckpt"))
    cfg_path = os.path.join(d, "config.yaml")
    first = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu")
    out = capsys.readouterr().out
    assert ">> GPT weights restored from: " in out and ">> bigvgan weights restored from: " in out
    assert os.path.exists(os.path.join(d, "gpt.pth.npz")) and os.path.exists(os.path.join(d, "bigvgan_generator.pth.npz"))
    assert first.gpt.text_embedding.dtype == torch.float32
    je = JaxIndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False)
    second = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu")
    out = capsys.readouterr().out
    assert out.count("weights restored from cache: ") == 4  # JAX's two, then the port's two

    wav_t, codes_t = _recording_infer(first, **GREEDY)
    wav_j, codes_j = _recording_infer(je, **GREEDY)
    wav_2, codes_2 = _recording_infer(second, **GREEDY)
    assert len(codes_t) == len(codes_j) == 2
    for a, b, c in zip(codes_t, codes_j, codes_2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert wav_t.shape == wav_j.shape and wav_t.dtype == np.int16 and wav_t.shape[0] > 0
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= WAV_TOL
    np.testing.assert_array_equal(wav_2, wav_t)


def test_engine_loads_jax_written_cache(ckpt_dir, tmp_path):
    """Caches the JAX engine wrote load into the port with the weights of the
    port's own conversion."""
    from indextts_tpu.engine import IndexTTS as JaxIndexTTS
    from indextts_tpu_torch.engine import IndexTTS

    jd = _fresh_copy(ckpt_dir, str(tmp_path / "jax"))
    JaxIndexTTS(cfg_path=os.path.join(jd, "config.yaml"), model_dir=jd, is_fp16=False)
    td = _fresh_copy(ckpt_dir, str(tmp_path / "port"))
    from_pth = IndexTTS(cfg_path=os.path.join(td, "config.yaml"), model_dir=td, is_fp16=False, device="cpu")
    for f in os.listdir(jd):
        if f.endswith(".pth"):
            os.remove(os.path.join(jd, f))  # only the caches are left to load from
    from_cache = IndexTTS(cfg_path=os.path.join(jd, "config.yaml"), model_dir=jd, is_fp16=False, device="cpu")
    for a, b in ((from_pth.gpt, from_cache.gpt), (from_pth.bigvgan, from_cache.bigvgan)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("missing", ["gpt.pth", "bigvgan_generator.pth"])
def test_missing_checkpoint_raises_or_random_inits(ckpt_dir, tmp_path, missing, capsys):
    """Without allow_random_init a missing checkpoint raises
    FileNotFoundError naming it; with it, that model alone is randomly
    initialized from the seed and the other one is loaded."""
    from indextts_tpu_torch.engine import IndexTTS

    d = _fresh_copy(ckpt_dir, str(tmp_path / "ckpt"))
    os.remove(os.path.join(d, missing))
    cfg_path = os.path.join(d, "config.yaml")
    with pytest.raises(FileNotFoundError, match=missing):
        IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu")
    capsys.readouterr()
    mixed = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu", allow_random_init=True)
    out = capsys.readouterr().out
    name = "GPT" if missing == "gpt.pth" else "bigvgan"
    assert f">> {name} randomly initialized (no checkpoint at {os.path.join(d, missing)} )" in out
    loaded = {"gpt.pth": "bigvgan", "bigvgan_generator.pth": "GPT"}[missing]
    assert f">> {loaded} weights restored from" in out  # the raising call may have written its cache
    if missing == "gpt.pth":
        # the GPT draws first from the seed's generator, as in a fully random engine
        shutil.rmtree(d)
        os.makedirs(d)
        tiny = tiny_config()
        from indextts_tpu_torch.config import save_config

        save_config(tiny, cfg_path)
        rand = IndexTTS(cfg_path=cfg_path, model_dir=d, is_fp16=False, device="cpu", allow_random_init=True)
        for k, v in rand.gpt.state_dict().items():
            torch.testing.assert_close(mixed.gpt.state_dict()[k], v, rtol=0, atol=0, msg=k)
    else:
        wav, _ = _recording_infer(mixed, text="HELLO.", do_sample=False, num_beams=1, max_mel_tokens=8)
        assert wav.shape[0] > 0
