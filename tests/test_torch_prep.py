"""The port's dataset-preparation jobs against the JAX package's.

The same inputs, made from a seed, go through both packages:
``sharding.shard`` under the same task environment; ``video_io``'s
``ffmpeg_once`` / ``save_array`` / ``probe_duration`` and ``ffmpeg_job``
with ``subprocess.run`` stubbed in both (the same argv, paths and skips),
and the no-ffmpeg ``.avi`` path byte for byte; ``encode_job`` over two tiny
``.avi`` videos (one with a padded last batch) with one tiny SigLIP
``.safetensors`` written with numpy and a narrow vision config patched into
each job (features within fp16 rounding, the same output names);
``narration_refinement_job`` and LiveChat synthesis with one scripted
``generate_fn`` (byte-equal JSON), and ``make_llama_generate_fn`` on a tiny
bridged model (the same strings); ``coin/download_videos`` with stubbed
yt-dlp and ffmpeg. Then every launch script under ``scripts/`` through the
port's ``core/arguments.parse_args`` and ``data/registry.py``.
"""

import json
import os
import random
import subprocess
import types

import numpy as np
import pytest

import jax
import torch
from safetensors.numpy import save_file

from videollm_online_tpu.core.config import VisionConfig as JaxVisionConfig
from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.data import video_io as jax_video_io
from videollm_online_tpu.data.coin import download_videos as jax_download
from videollm_online_tpu.data.livechat import generation as jax_livechat
from videollm_online_tpu.data.livechat import templates as jax_templates
from videollm_online_tpu.data.preprocess import encode_job as jax_encode
from videollm_online_tpu.data.preprocess import ffmpeg_job as jax_ffmpeg_job
from videollm_online_tpu.data.preprocess import (
    narration_refinement_job as jax_refine)
from videollm_online_tpu.data.preprocess import sharding as jax_sharding
from videollm_online_tpu.models import builder as jax_builder
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core.arguments import parse_args
from videollm_online_tpu_torch.core.config import VisionConfig
from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.data import avi, feature_store, video_io
from videollm_online_tpu_torch.data.coin import download_videos
from videollm_online_tpu_torch.data.livechat import generation as livechat
from videollm_online_tpu_torch.data.livechat import templates
from videollm_online_tpu_torch.data.preprocess import (
    encode_job, ffmpeg_job, narration_refinement_job, sharding)
from videollm_online_tpu_torch.data.registry import available_datasets
from videollm_online_tpu_torch.models import builder
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

from test_scripts import SCRIPTS, _script_args

# encode_job writes fp16: both packages compute the same fp32 features to
# about 1e-6, and rounding those to fp16 may land on neighbouring values,
# one fp16 ulp apart (2^-10 relative, at most 6.1e-5 below fp16's smallest
# normal)
FP16_RTOL, FP16_ATOL = 2.0 ** -10, 6.1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- sharding

@pytest.mark.parametrize("env", [
    {}, {"VLO_NUM_TASKS": "3", "VLO_TASK_RANK": "1"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
    {"VLO_NUM_TASKS": "4", "SLURM_NTASKS": "2", "SLURM_PROCID": "1"}],
    ids=["none", "vlo", "slurm", "vlo_first"])
def test_sharding_equals_jax(env, monkeypatch):
    for k in ("VLO_NUM_TASKS", "VLO_TASK_RANK", "SLURM_NTASKS",
              "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    items = [f"v{i}.mp4" for i in range(11)]
    assert sharding.task_env() == jax_sharding.task_env()
    assert list(sharding.shard(items)) == list(jax_sharding.shard(items))


# ------------------------------------------------------- ffmpeg and video IO

class _Runs(list):
    """A ``subprocess.run`` stub: records each argv, returns ``stdout``."""

    def __init__(self, stdout=b""):
        super().__init__()
        self.stdout = stdout

    def __call__(self, cmd, **kw):
        self.append(list(cmd))
        return types.SimpleNamespace(stdout=self.stdout, returncode=0)


def _stub(monkeypatch, ffmpeg, stdout=b""):
    """One ``subprocess.run`` stub (both packages call the same
    ``subprocess`` module), and ``ffmpeg`` as each video_io's binary."""
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod, "_FFMPEG", ffmpeg)
    runs = _Runs(stdout)
    monkeypatch.setattr(subprocess, "run", runs)
    return runs


def _issued(runs, fn):
    """The argvs ``fn()`` issues through the stub."""
    n = len(runs)
    fn()
    return runs[n:]


def test_ffmpeg_once_and_job_equal_jax(tmp_path, monkeypatch):
    src_root = tmp_path / "videos"
    for rel in ("a.mp4", "sub/b.mp4", "sub/c.mp4", "notes.txt", "d.avi"):
        (src_root / rel).parent.mkdir(parents=True, exist_ok=True)
        (src_root / rel).write_bytes(b"")
    dst_root = ffmpeg_job.dst_root_for(str(src_root), 2.0, 384)
    assert dst_root == jax_ffmpeg_job.dst_root_for(str(src_root), 2.0, 384)
    for fps, res in ((None, None), (2.0, None), (None, 224), (0.5, 384)):
        assert (ffmpeg_job.dst_root_for(str(src_root) + "/", fps, res)
                == jax_ffmpeg_job.dst_root_for(str(src_root) + "/", fps, res))
    # an existing output is skipped by both
    os.makedirs(os.path.join(dst_root, "sub"))
    open(os.path.join(dst_root, "sub", "b.mp4"), "wb").close()
    runs = _stub(monkeypatch, "/opt/ff/ffmpeg")
    got, want = (_issued(runs, lambda m=m: m.main(["--video_dir",
                                                   str(src_root)]))
                 for m in (ffmpeg_job, jax_ffmpeg_job))
    assert got == want and len(got) == 2
    assert got[0][-1] == os.path.join(dst_root, "a.mp4")
    # ffmpeg_once on its own: every filter combination, the same argv
    for fps, res in ((None, None), (2, None), (None, 64), (2, 384)):
        got, want = (_issued(runs, lambda m=m: m.ffmpeg_once(
            "in.mp4", str(tmp_path / "o/x.mp4"), fps=fps, resolution=res))
            for m in (video_io, jax_video_io))
        assert got == want and len(got) == 1


def test_ffmpeg_once_without_ffmpeg_equals_jax(tmp_path, monkeypatch):
    """No ffmpeg: an .avi goes through the first-party path in both (the
    same bytes out); anything else raises the same error."""
    frames = np.random.RandomState(0).randint(0, 256, (9, 30, 40, 3),
                                              dtype=np.uint8)
    src = str(tmp_path / "src.avi")
    avi.write_avi(src, frames, 6.0)
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod, "_FFMPEG", "")
    outs = []
    for mod, name in ((video_io, "mine"), (jax_video_io, "theirs")):
        dst = str(tmp_path / name / "out.avi")
        mod.ffmpeg_once(src, dst, fps=2, resolution=32)
        outs.append(open(dst, "rb").read())
    assert outs[0] == outs[1]
    errors = []
    for mod in (video_io, jax_video_io):
        with pytest.raises(RuntimeError) as e:
            mod.ffmpeg_once(str(tmp_path / "x.mp4"), str(tmp_path / "y.mp4"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "ffmpeg" in errors[0]


def test_save_array_and_probe_duration_equal_jax(tmp_path, monkeypatch):
    arr = np.random.RandomState(1).randn(5, 10, 8).astype(np.float16)
    for ext in (".npy", ".pt"):
        mine, theirs = (str(tmp_path / d / f"f{ext}") for d in ("a", "b"))
        video_io.save_array(mine, arr)
        jax_video_io.save_array(theirs, arr)
        np.testing.assert_array_equal(video_io.load_array(mine),
                                      jax_video_io.load_array(theirs))
        if ext == ".npy":
            assert open(mine, "rb").read() == open(theirs, "rb").read()
    for mod in (video_io, jax_video_io):
        with pytest.raises(ValueError):
            mod.save_array(str(tmp_path / "f.bin"), arr)
    # without ffprobe: an .avi's header, else an error
    src = str(tmp_path / "p.avi")
    avi.write_avi(src, np.zeros((7, 8, 8, 3), np.uint8), 2.0)
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    assert video_io.probe_duration(src) == jax_video_io.probe_duration(src)
    for mod in (video_io, jax_video_io):
        with pytest.raises(RuntimeError, match="ffprobe"):
            mod.probe_duration(str(tmp_path / "p.mp4"))
    # with one: the same argv, the duration parsed from its JSON
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod.shutil, "which", lambda name: "/x/ffprobe")
    runs = _stub(monkeypatch, "", json.dumps(
        {"format": {"duration": "12.25"}}).encode())
    got, want = (_issued(runs, lambda m=m: m.probe_duration("v.mp4"))
                 for m in (video_io, jax_video_io))
    assert got == want and len(got) == 1
    assert video_io.probe_duration("v.mp4") == 12.25


# ---------------------------------------------------------------- encode_job

def _tiny_siglip_state_dict(vcfg, seed=0):
    """An HF SiglipVisionModel state dict at ``vcfg``'s widths, numpy."""
    rng = np.random.RandomState(seed)
    D, F, P = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size

    def w(*shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def lin(prefix, dout, din):
        return {prefix + ".weight": w(dout, din),
                prefix + ".bias": w(dout, scale=0.01)}

    def ln(prefix):
        return {prefix + ".weight": 1 + w(D, scale=0.1),
                prefix + ".bias": w(D, scale=0.1)}

    sd = {"embeddings.patch_embedding.weight": w(D, 3, P, P),
          "embeddings.patch_embedding.bias": w(D, scale=0.01),
          "embeddings.position_embedding.weight": w(vcfg.grid_size ** 2, D),
          **ln("post_layernorm")}
    for i in range(vcfg.num_layers):
        p = f"encoder.layers.{i}."
        sd.update({**ln(p + "layer_norm1"), **ln(p + "layer_norm2"),
                   **lin(p + "self_attn.q_proj", D, D),
                   **lin(p + "self_attn.k_proj", D, D),
                   **lin(p + "self_attn.v_proj", D, D),
                   **lin(p + "self_attn.out_proj", D, D),
                   **lin(p + "mlp.fc1", F, D), **lin(p + "mlp.fc2", D, F)})
    sd.update({"head.probe": w(1, 1, D, scale=1.0),
               "head.attention.in_proj_weight": w(3 * D, D),
               "head.attention.in_proj_bias": w(3 * D, scale=0.01),
               **lin("head.attention.out_proj", D, D), **ln("head.layernorm"),
               **lin("head.mlp.fc1", F, D), **lin("head.mlp.fc2", D, F)})
    return sd


def test_encode_job_equals_jax(tmp_path, monkeypatch):
    # 384 px frames (the readers' default resolution) in 8 x 8 patches of
    # 48, one narrow fp32 layer
    narrow = dict(patch_size=48, hidden_size=32, intermediate_size=64,
                  num_layers=1, num_heads=2, dtype="float32")
    for mod, vc in ((encode_job, VisionConfig), (jax_encode, JaxVisionConfig)):
        make = mod.live1_plus_config
        monkeypatch.setattr(mod, "live1_plus_config",
                            lambda make=make, vc=vc: make().replace(
                                vision=vc(**narrow)))
    weights = str(tmp_path / "siglip.safetensors")
    save_file(_tiny_siglip_state_dict(VisionConfig(**narrow)), weights)
    lengths = {"clip_b": 6, "clip_a": 4}     # batch 4: clip_b pads a batch
    outs = {}
    for name, mod in (("mine", encode_job), ("theirs", jax_encode)):
        root = tmp_path / name / "videos"
        root.mkdir(parents=True)
        for uid, n in lengths.items():
            avi.write_avi(str(root / f"{uid}.avi"), np.random.RandomState(
                len(uid) + n).randint(0, 256, (n, 24, 40, 3), dtype=np.uint8),
                2.0)
        argv = ["--video_dir", str(root), "--weights", weights,
                "--batch_size", "4"]
        mod.main(argv + (["--device", "cpu"] if mod is encode_job else []))
        outs[name] = sorted(os.listdir(root.parent))
        dst = root.parent / outs[name][-1]
        # a second run skips what exists
        (dst / "clip_a.npy").write_bytes(b"kept")
        mod.run(str(root), weights=weights, batch_size=4,
                **({"device": "cpu"} if mod is encode_job else {}))
        assert (dst / "clip_a.npy").read_bytes() == b"kept"
        (dst / "clip_a.npy").unlink()
        mod.run(str(root), weights=weights, batch_size=4,
                **({"device": "cpu"} if mod is encode_job else {}))
        outs[name] = (outs[name], dst)
    assert outs["mine"][0] == outs["theirs"][0] == [
        "videos", "videos_1+3x3_google--siglip-large-patch16-384"]
    for uid, n in lengths.items():
        got = np.load(outs["mine"][1] / f"{uid}.npy")
        want = np.load(outs["theirs"][1] / f"{uid}.npy")
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (n, 10, 32)
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=FP16_RTOL, atol=FP16_ATOL)
        # the feature store reads the output as the datasets do
        path = str(outs["mine"][1] / f"{uid}.npy")
        assert feature_store.feature_len(path) == n
        np.testing.assert_array_equal(
            feature_store.load_feature_range(path, range(1, n)), got[1:n])


def test_encode_job_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_job.run(str(tmp_path))


# ------------------------------------------------- refinement and LiveChat

def _scripted(prompt: str) -> str:
    """One deterministic generate_fn for both packages: an answer drawn
    from the prompt's bytes, sometimes without the closing bracket (the
    fallback), sometimes a timestamped dialogue."""
    h = sum(prompt.encode()) % 7
    if "User:" in prompt:
        times = [line.split("s User:")[0] for line in prompt.splitlines()
                 if "s User:" in line]
        lines = [f"{t}s Assistant: step {i} looks fine." for i, t in
                 enumerate(times)] + ["noise line", "90.5s User: and now?"]
        if h % 2:   # a dialogue that leaks time words, which the filter drops
            lines.append(f"[{h}.0s] assistant: at {h} seconds")
        return "\n".join(lines)
    return f"You do thing {h}.] trailing" if h % 3 else "no bracket here"


def _narration_root(root):
    anno = {f"vid_{i}": {"au1": [
        {"time": 1.0 * j, "text": f"C does {i}-{j} #X."} for j in range(3)]
        + [{"time": 9.0, "text": "C looks around."}]} for i in range(4)}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "narration_stream_train.json"), "w") as f:
        json.dump(anno, f)
    done = os.path.join(root, "refined_narration_stream_train")
    os.makedirs(done)
    with open(os.path.join(done, "vid_2.json"), "w") as f:
        f.write("{}")


def _goalstep_root(root):
    os.makedirs(root, exist_ok=True)
    videos = []
    for i in range(3):
        segs = [{"start_time": 10.0 * j + 0.3, "end_time": 10.0 * j + 7.9,
                 "step_description": f" step {i}.{j} ",
                 "segments": ([{"start_time": 10.0 * j + 1.1 + k,
                                "end_time": 10.0 * j + 1.6 + k,
                                "step_description": f"sub {k}"}
                               for k in range(3)] if j == 1 else [])}
                for j in range(4)]
        videos.append({"video_uid": f"g{i}", "start_time": 0.0,
                       "end_time": 45.0, "goal_description": f"goal {i} ",
                       "segments": segs if i != 2 else []})
    with open(os.path.join(root, "goalstep_train.json"), "w") as f:
        json.dump({"videos": videos[:2]}, f)
    with open(os.path.join(root, "goalstep_val.json"), "w") as f:
        json.dump({"videos": videos[2:]}, f)
    return {"g0": {"duration": 44.0}, "g1": {"duration": 120.0}}


def test_templates_are_the_jax_bytes():
    import inspect
    assert inspect.getsource(templates) == inspect.getsource(jax_templates)
    assert templates.ALL_QUERY_TEMPLATES == jax_templates.ALL_QUERY_TEMPLATES


def test_refinement_and_livechat_equal_jax(tmp_path):
    # refinement: the same refined files, the existing one skipped
    for name, mod in (("mine", narration_refinement_job),
                      ("theirs", jax_refine)):
        _narration_root(str(tmp_path / name))
        mod.run(str(tmp_path / name), "train", _scripted)
    out = "refined_narration_stream_train"
    files = sorted(os.listdir(tmp_path / "mine" / out))
    assert files == sorted(os.listdir(tmp_path / "theirs" / out))
    assert len(files) == 4
    for f in files:
        assert ((tmp_path / "mine" / out / f).read_bytes()
                == (tmp_path / "theirs" / out / f).read_bytes())
    assert narration_refinement_job.REFINE_PROMPT == jax_refine.REFINE_PROMPT
    for raw in ("C cuts.", "Man X waves"):
        c1, c2 = {}, {}
        assert (narration_refinement_job.refine_text(raw, _scripted, c1)
                == jax_refine.refine_text(raw, _scripted, c2))
        assert c1 == c2

    # LiveChat: transcripts, synthesized dialogues and the filter
    metadata = _goalstep_root(str(tmp_path / "goalstep"))
    root = str(tmp_path / "goalstep")
    assert (livechat.goalstep_transcripts(root)
            == jax_livechat.goalstep_transcripts(root))
    blobs = []
    for name, mod in (("mine", livechat), ("theirs", jax_livechat)):
        path = str(tmp_path / f"{name}_chat.json")
        annos = mod.synthesize(root, metadata, _scripted, num_queries=2,
                               num_conversations=3, seed=5, out_path=path)
        kept = mod.filter_dialogues(annos, min_duration=5.0)
        blobs.append((open(path, "rb").read(), json.dumps(kept)))
    assert blobs[0] == blobs[1]
    assert json.loads(blobs[0][0]) and json.loads(blobs[0][1])
    text = ("1.0s Assistant: a\nnoise\n [2.5s] user : b ?\n"
            "3s Assistant: c\n4.5 Assistant: no unit")
    assert (livechat.parse_dialogue(text) == jax_livechat.parse_dialogue(text)
            and len(livechat.parse_dialogue(text)) == 3)
    assert livechat.build_prompt([(0.0, 1.5, "x")], [(1.0, "q?")]) == \
        jax_livechat.build_prompt([(0.0, 1.5, "x")], [(1.0, "q?")])


def test_make_llama_generate_fn_equals_jax(monkeypatch):
    """The refinement decoder on the tiny model, the same weights in both
    packages (each builder patched to return them)."""
    jtok = JaxTokenizer(JaxBytes(), jax_tiny_cfg())
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(4),
                                                  jtok.cfg))
    params = params_from_numpy(jparams, device="cpu")
    seen = []

    def fake(tree, tk):
        def build(args, is_training=True, **kw):
            seen.append((args.llm_weights, args.lora_r, is_training, kw))
            return tree, tk, tk.cfg
        return build
    monkeypatch.setattr(jax_builder, "build_model_and_tokenizer",
                        fake(jparams, jtok))
    monkeypatch.setattr(builder, "build_model_and_tokenizer",
                        fake(params, tok))
    mine = narration_refinement_job.make_llama_generate_fn(
        "w", "", max_new_tokens=12, device="cpu")
    theirs = jax_refine.make_llama_generate_fn("w", "", max_new_tokens=12)
    assert seen == [("w", 0, False, {"device": "cpu"}), ("w", 0, False, {})]
    prompts = [narration_refinement_job.REFINE_PROMPT.format(text=t)
               for t in ("C cuts a bag.", "C opens a lid.")]
    got = [mine(p) for p in prompts]
    assert got == [theirs(p) for p in prompts]
    assert all(got)


# --------------------------------------------------------- COIN downloader

class _Net:
    """yt-dlp and ffmpeg stubs: which ids verify, download or fail."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.calls = []

    def __call__(self, cmd, **kw):
        self.calls.append(tuple(cmd))
        if cmd[0].endswith("ffmpeg"):
            if "broken" in cmd[4]:
                raise subprocess.CalledProcessError(1, cmd)
            return types.SimpleNamespace(returncode=0)
        url = cmd[-1] if "--ffmpeg-location" not in cmd else cmd[-3]
        if "gone" in url:
            raise subprocess.CalledProcessError(1, cmd, stderr="a\nERROR: 404")
        if "nobin" in url:
            raise FileNotFoundError("yt-dlp")
        return types.SimpleNamespace(returncode=0)


@pytest.mark.parametrize("ffmpeg", [None, "/opt/ff"])
def test_download_videos_equals_jax(tmp_path, ffmpeg, monkeypatch):
    ids = {"ok": "u/ok", "fine": "u/fine", "broken": "u/broken",
           "new": "u/new", "gone": "u/gone", "nobin": "u/nobin"}
    db = {"database": {k: {"video_url": v} for k, v in ids.items()}}
    json_path = str(tmp_path / "coin.json")
    with open(json_path, "w") as f:
        json.dump(db, f)
    results = []
    for name, mod in (("mine", download_videos), ("theirs", jax_download)):
        out = tmp_path / name
        out.mkdir()
        for k in ("ok", "fine", "broken"):
            (out / f"{k}.mp4").write_bytes(b"x")
        net = _Net(str(out))
        monkeypatch.setattr(subprocess, "run", net)
        random.seed(0)
        res = mod.download_all(str(out), json_path, num_workers=3,
                               ffmpeg_location=ffmpeg)
        calls = sorted(tuple(c.replace(str(out), "<out>") for c in call)
                       for call in net.calls)
        results.append((sorted(res), calls, sorted(os.listdir(out))))
    assert results[0] == results[1]
    status = dict(results[0][0])
    assert status["ok"] == "verified" and status["new"] == "downloaded"
    assert status["broken"] == "downloaded"
    assert status["gone"] == "error: ERROR: 404"
    assert status["nobin"] == "error: yt-dlp not installed"


# ---------------------------------------------------------- launch scripts

@pytest.mark.parametrize("path", SCRIPTS,
                         ids=lambda p: str(p.parent.name + "/" + p.name))
def test_scripts_resolve_through_the_port(path):
    """Each launch script's flags parse through the port's arguments and
    name only datasets the port's registry holds."""
    module, args = _script_args(path)
    parsed = parse_args(args)
    known = set(available_datasets())
    named = (parsed.train_datasets or []) + (parsed.eval_datasets or [])
    assert named and set(named) <= known, (path.name, named)
    assert parsed.to_live_config().frame_num_tokens == parsed.frame_num_tokens
