"""The port's vision towers against HF and the JAX package.

Tiny SigLIP and CLIP models built at random by ``transformers`` (nothing
is downloaded) are converted by both packages' converters; the port's
``encode`` and ``frame_features`` are held against HF's outputs and the JAX
package's on the same pixels, fp32 throughout. The JAX package's own random
trees cross through ``vision_params_from_numpy`` (the bridge) in bf16;
``pixels_to_embeds`` (tower + connector) on a bridged fp32 tree is held
against the JAX engine's encoder in tests/test_torch_engine_options.py.
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

os.environ.setdefault("USE_TF", "0")   # transformers' TF import is slow
import transformers  # noqa: E402

from videollm_online_tpu.core.config import VisionConfig as JaxVisionConfig
from videollm_online_tpu.core.config import live1_config as jax_live1
from videollm_online_tpu.core.config import live1_plus_config as jax_live1p
from videollm_online_tpu.models import clip as jax_clip
from videollm_online_tpu.models import siglip as jax_siglip
from videollm_online_tpu.models.convert import (
    siglip_params_from_state_dict as jax_siglip_convert)

from videollm_online_tpu_torch.core.config import (
    VisionConfig, live1_config, live1_plus_config)
from videollm_online_tpu_torch.models import clip, siglip, vision
from videollm_online_tpu_torch.models.bridge import vision_params_from_numpy
from videollm_online_tpu_torch.models.convert import (
    siglip_params_from_state_dict)

# fp32 against HF: the JAX package's own bounds (test_siglip_parity.py,
# test_clip_parity.py); against JAX the same fp32 math in another order
HF_TOL = dict(atol=3e-4, rtol=3e-3)
JAX_TOL = dict(atol=2e-5, rtol=2e-4)
# bf16 tree, port vs JAX, relative norm of the frame features: readings
# 5.6e-3 (siglip) and 4.9e-3 (clip) on these shapes; both round the same
# bf16 matmuls, XLA once per fused chain and eager after every op
BF16_REL = 1.5e-2

TINY = dict(image_size=48, patch_size=8, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=["siglip", "clip"])
def tower(request):
    """(family, torch cfg, jax cfg, hf model, torch params, jax params).
    The JAX tower runs under one jit per function: eagerly, every call of
    its layer scan compiles anew."""
    torch.manual_seed(0)
    if request.param == "siglip":
        cfg, jcfg = VisionConfig(**TINY), JaxVisionConfig(**TINY)
        hf = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=48, patch_size=8,
            layer_norm_eps=cfg.layer_norm_eps)).eval()
        sd = hf.state_dict()
        return ("siglip", cfg, jcfg, hf,
                siglip_params_from_state_dict(sd, cfg, device="cpu"),
                jax_siglip_convert(sd, jcfg, dtype="float32"))
    cfg = clip.clip_vision_config(**TINY)
    jcfg = jax_clip.clip_vision_config(**TINY)
    hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, image_size=48, patch_size=8,
        layer_norm_eps=cfg.layer_norm_eps, hidden_act="quick_gelu")).eval()
    sd = hf.state_dict()
    return ("clip", cfg, jcfg, hf,
            clip.params_from_state_dict(sd, cfg, device="cpu"),
            jax_clip.params_from_state_dict(sd, jcfg, dtype="float32"))


def _mods(family):
    return (siglip, jax_siglip) if family == "siglip" else (clip, jax_clip)


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def test_encode_matches_hf_and_jax(tower):
    family, cfg, jcfg, hf, params, jparams = tower
    mod, jmod = _mods(family)
    pixels = np.random.RandomState(0).randn(
        2, 3, 48, 48).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(pixels))
        hidden, pooled = mod.encode(params, torch.tensor(pixels), cfg)
    jh, jp = _jit(jmod.encode, 2)(jparams, jnp.asarray(pixels), jcfg)
    np.testing.assert_allclose(_np(hidden), ref.last_hidden_state.numpy(),
                               **HF_TOL)
    np.testing.assert_allclose(_np(pooled), ref.pooler_output.numpy(),
                               **HF_TOL)
    np.testing.assert_allclose(_np(hidden), np.asarray(jh), **JAX_TOL)
    np.testing.assert_allclose(_np(pooled), np.asarray(jp), **JAX_TOL)


@pytest.mark.parametrize("layout", ["live1_plus", "live1"])
def test_frame_features_match_reference_epilogue(tower, layout):
    """CLS (+ 3 x 3 adaptive-average-pooled patches for live1+), held
    against the reference epilogue recomputed on HF's outputs and, for
    live1+, against the JAX package's frame_features."""
    family, cfg, jcfg, hf, params, jparams = tower
    mod, jmod = _mods(family)
    make, jmake = ((live1_plus_config, jax_live1p) if layout == "live1_plus"
                   else (live1_config, jax_live1))
    live_cfg = make(vision=cfg, vision_hidden_size=64)
    jlive = jmake(vision=jcfg, vision_hidden_size=64)
    pixels = np.random.RandomState(1).randn(2, 3, 48, 48).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.tensor(pixels))
        lh = out.last_hidden_state
        cls = (out.pooler_output[:, None] if family == "siglip"
               else lh[:, :1])
        patches = lh if family == "siglip" else lh[:, 1:]
        s = int(math.isqrt(patches.shape[1]))
        spatial = torch.nn.functional.adaptive_avg_pool2d(
            patches.reshape(2, s, s, -1).permute(0, 3, 1, 2),
            (3, 3)).flatten(2, 3).permute(0, 2, 1)
        ref = (torch.cat([cls, spatial], dim=1) if layout == "live1_plus"
               else cls).numpy()
        got = mod.frame_features(params, torch.tensor(pixels), cfg, live_cfg)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), ref, **HF_TOL)
    if layout == "live1_plus":
        want = _jit(jmod.frame_features, 2, 3)(jparams, jnp.asarray(pixels),
                                               jcfg, jlive)
        np.testing.assert_allclose(_np(got), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("grid,out", [(24, (3, 3)), (5, (3, 3)),
                                      (7, (2, 3)), (4, (4, 4))])
def test_spatial_pool_torch_bins(grid, out):
    """Two averaging matmuls with adaptive_avg_pool2d's bins, for grids that
    divide and grids that do not; equal to the JAX package's."""
    x = np.random.RandomState(grid).randn(2, grid * grid, 8).astype(
        np.float32)
    got = siglip.spatial_pool(torch.tensor(x), out)
    ref = torch.nn.functional.adaptive_avg_pool2d(
        torch.tensor(x).reshape(2, grid, grid, 8).permute(0, 3, 1, 2),
        out).flatten(2, 3).permute(0, 2, 1)
    np.testing.assert_allclose(_np(got), ref.numpy(), atol=1e-6)
    want = jax_siglip.spatial_pool(jnp.asarray(x), out)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_preprocess_matches_jax():
    frames = np.random.RandomState(0).randint(
        0, 256, (2, 3, 8, 8)).astype(np.uint8)
    for mod, jmod, cfg, jcfg in (
            (siglip, jax_siglip, VisionConfig(), JaxVisionConfig()),
            (clip, jax_clip, clip.clip_vision_config(),
             jax_clip.clip_vision_config())):
        got = mod.preprocess(torch.tensor(frames), cfg)
        want = jmod.preprocess(jnp.asarray(frames), jcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("family", ["siglip", "clip"])
def test_jax_random_tree_through_bridge(family):
    """The JAX package's own random bf16 tree, fetched to numpy and carried
    over by ``vision_params_from_numpy``: the same frame features from
    uint8 pixels within BF16_REL (fp32 trees cross in the engine's vision
    cases, tests/test_torch_engine_options.py, with pixels_to_embeds held
    to the JAX engine's encoder there)."""
    dtype = "bfloat16"
    mod, jmod = _mods(family)
    kw = dict(TINY, dtype=dtype)
    if family == "siglip":
        cfg, jcfg = VisionConfig(**kw), JaxVisionConfig(**kw)
    else:
        cfg, jcfg = clip.clip_vision_config(**kw), \
            jax_clip.clip_vision_config(**kw)
    jparams = jax.device_get(jmod.init_params(jax.random.PRNGKey(3), jcfg))
    params = vision_params_from_numpy(jparams, device="cpu")
    assert params["layers"]["ln1"]["scale"].dtype == getattr(torch, dtype)
    live_cfg = live1_plus_config(vision=cfg, vision_hidden_size=64)
    jlive = jax_live1p(vision=jcfg, vision_hidden_size=64)
    px = np.random.RandomState(4).randint(0, 256, (3, 3, 48, 48)).astype(
        np.uint8)
    got = mod.frame_features(params, mod.preprocess(torch.tensor(px), cfg),
                             cfg, live_cfg)
    want = _jit(lambda p, x: jmod.frame_features(
        p, jmod.preprocess(x, jcfg), jcfg, jlive))(jparams, jnp.asarray(px))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < BF16_REL


@pytest.mark.parametrize("name,family,quick", [
    ("google/siglip-large-patch16-384", "siglip", None),
    ("openai/clip-vit-large-patch14-336", "clip", True),
    ("laion/CLIP-ViT-L-14-laion2B-s32B-b82K", "clip", False),
    ("facebook/dinov2-large", None, None)])
def test_build_vision_dispatch(name, family, quick):
    cfg = live1_plus_config()
    if family is None:
        with pytest.raises(ValueError, match="unverified"):
            vision.build_vision(name, cfg)
        return
    fns = vision.build_vision(name, cfg)
    assert fns.config.family == family
    if family == "siglip":
        assert fns.config == cfg.vision
        assert fns.params_from_state_dict is \
            siglip_params_from_state_dict
    else:
        assert fns.config.image_size == 336 and fns.config.patch_size == 14
        # quick-GELU only for openai: the two GELUs part on a tiny tower
        tiny = clip.clip_vision_config(**TINY)
        fns = vision.build_vision(name, cfg, tiny)
        p = clip.init_params(torch.Generator().manual_seed(0), tiny,
                             device="cpu")
        px = torch.randint(0, 256, (1, 3, 48, 48), dtype=torch.uint8)
        got = fns.frame_features(p, px)
        x = clip.preprocess(px, tiny)
        want = clip.frame_features(p, x, tiny, cfg, quick_gelu=quick)
        other = clip.frame_features(p, x, tiny, cfg, quick_gelu=not quick)
        torch.testing.assert_close(got, want)
        assert not torch.allclose(got, other)
