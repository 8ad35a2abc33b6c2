"""The port's tokenizer copies against the JAX package's.

The port keeps its own copy of the framework-free tokenizer and config
modules; the ids the serving loop feeds must be the same: the system and
stream prompt, a query prompt, the response prompt and the reopen ids.
"""

import dataclasses

import pytest

from videollm_online_tpu.core import config as jax_config
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core import config
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

PRESETS = ["tiny_live_config", "live1_plus_config"]

TEMPLATES = {
    "system_stream": (
        [{"role": "system", "content": "A streaming assistant."}],
        dict(add_stream_prompt=True)),
    "query": (
        [{"role": "user", "content": "what is happening?"}],
        dict(add_stream_query_prompt=True, add_generation_prompt=True)),
    "dialogue": (
        [{"role": "system", "content": "sys"},
         {"role": "stream", "num_frames": 2},
         {"role": "user", "content": "hi"},
         {"role": "assistant", "content": "hello"}],
        dict(add_generation_prompt=True)),
}


def _pair(preset):
    return (JaxTokenizer(JaxBytes(), getattr(jax_config, preset)()),
            LiveTokenizer(ByteTokenizer(), getattr(config, preset)()))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_chat_template_ids_equal_jax(preset, name):
    jtok, tok = _pair(preset)
    conv, flags = TEMPLATES[name]
    want = jtok.apply_chat_template(conv, tokenize=True, **flags)
    got = tok.apply_chat_template(conv, tokenize=True, **flags)
    assert list(got) == list(want)
    assert tok.apply_chat_template(conv, **flags) == \
        jtok.apply_chat_template(conv, **flags)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("text", ["]\nAssistant:", "\n[", "a, b <v>,<v>"])
def test_encode_decode_equal_jax(preset, text):
    jtok, tok = _pair(preset)
    ids = list(tok.encode(text))
    assert ids == list(jtok.encode(text))
    assert tok.decode(ids, skip_special_tokens=True) == \
        jtok.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("preset", PRESETS)
def test_config_ids_equal_jax(preset):
    jtok, tok = _pair(preset)
    for name in ("v_placeholder_id", "frame_token_interval_id",
                 "eos_token_id", "bos_token_id", "frame_num_tokens",
                 "system_prompt", "frame_fps",
                 "frame_token_interval_threshold", "max_response_tokens"):
        assert getattr(tok.cfg, name) == getattr(jtok.cfg, name), name


@pytest.mark.parametrize("preset", ["live1_config", "live1_plus_config",
                                    "tiny_live_config", "tiny_llama_config",
                                    "tiny_vision_config"])
def test_config_presets_equal_jax(preset):
    """The port's copy of the config tree: every field of every preset it
    keeps equals the JAX package's."""
    assert dataclasses.asdict(getattr(config, preset)()) == \
        dataclasses.asdict(getattr(jax_config, preset)())
