"""LiveTokenizer: tokenizer facade binding the chat template, the ``<v>``
special token, and learn-range computation to any tokenizer backend.

Equivalent of the reference's ``build_live_tokenizer_and_update_config``
(models/tokenization_live.py:110-122): adds ``<v>`` as the last vocab id,
resolves the frame-interval token id, sets pad=eos, and exposes
``apply_chat_template`` / ``get_learn_ranges``. Backends:

  * any HF ``PreTrainedTokenizerFast`` (real Llama-3 use),
  * a raw ``tokenizers.Tokenizer`` json,
  * the self-contained byte-level tokenizer in tiny.py (tests; no network).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from ..core.config import LiveConfig
from .chat import ChatFormat, get_learn_ranges, render_conversation


class TokenizerBackend(Protocol):
    bos_token: str
    eos_token: str

    def encode_with_offsets(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str: ...
    def token_to_id(self, token: str) -> Optional[int]: ...
    def __len__(self) -> int: ...


class HFBackend:
    """Adapter over a transformers fast tokenizer."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.bos_token = hf_tokenizer.bos_token
        self.eos_token = hf_tokenizer.eos_token

    def encode_with_offsets(self, text):
        enc = self.hf(text, return_offsets_mapping=True, add_special_tokens=False)
        return enc["input_ids"], enc["offset_mapping"]

    def decode(self, ids, skip_special_tokens=False):
        return self.hf.decode(ids, skip_special_tokens=skip_special_tokens,
                              clean_up_tokenization_spaces=True)

    def token_to_id(self, token):
        ids = self.hf(token, add_special_tokens=False)["input_ids"]
        return ids[0] if len(ids) == 1 else None

    def __len__(self):
        return len(self.hf)


class LiveTokenizer:
    def __init__(self, backend: TokenizerBackend, cfg: LiveConfig):
        self.backend = backend
        self.fmt = ChatFormat(bos_token=backend.bos_token,
                              eos_token=backend.eos_token)
        v_id = backend.token_to_id(cfg.v_placeholder)
        assert v_id is not None, (
            f"backend must contain {cfg.v_placeholder!r} as a single token")
        interval_id = (backend.token_to_id(cfg.frame_token_interval)
                       if cfg.frame_token_interval else None)
        eos_id = backend.token_to_id(backend.eos_token)
        bos_id = backend.token_to_id(backend.bos_token)
        self.cfg = cfg.with_tokenizer_ids(
            v_placeholder_id=v_id,
            frame_token_interval_id=interval_id,
            eos_token_id=eos_id,
            bos_token_id=bos_id,
        )
        self.pad_token_id = eos_id  # pad = eos (tokenization_live.py:117)

    # -- rendering ---------------------------------------------------------
    def apply_chat_template(self, conversation, *, tokenize: bool = False,
                            **flags):
        text = render_conversation(conversation, self.cfg, self.fmt, **flags)
        if not tokenize:
            return text
        ids, _ = self.backend.encode_with_offsets(text)
        return ids

    def get_learn_ranges(self, conversation) -> List[range]:
        return get_learn_ranges(conversation, self.cfg, self.fmt)

    # -- encoding ----------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids, _ = self.backend.encode_with_offsets(text)
        return ids

    def batch_encode(self, texts: Sequence[str], pad_to_multiple: int = 1,
                     padding_side: str = "right") -> Dict[str, np.ndarray]:
        """Padded batch with offset mappings for label-range resolution.

        The reference tokenizes with padding_side='left'
        (tokenization_live.py:111) and relies on the attention_mask to hide
        pads. Here training batches pad RIGHT: with a causal mask, real
        tokens then never attend pad slots and RoPE positions equal slot
        indices — no separate attention mask needed on the TPU fast path.
        'left' remains available for HF-style batched generation."""
        encs = [self.backend.encode_with_offsets(t) for t in texts]
        max_len = max(len(ids) for ids, _ in encs)
        if pad_to_multiple > 1:
            max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
        B = len(texts)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int64)
        attention_mask = np.zeros((B, max_len), np.int64)
        offsets = np.zeros((B, max_len, 2), np.int64)
        for i, (ids, offs) in enumerate(encs):
            n = len(ids)
            sl = slice(max_len - n, max_len) if padding_side == "left" \
                else slice(0, n)
            input_ids[i, sl] = ids
            attention_mask[i, sl] = 1
            offsets[i, sl] = offs
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "offset_mapping": offsets}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = list(np.asarray(ids).reshape(-1))
        return self.backend.decode(ids, skip_special_tokens=skip_special_tokens)

    def __len__(self):
        return len(self.backend)


def build_live_tokenizer(backend_or_hf, cfg: LiveConfig) -> LiveTokenizer:
    """Wrap an HF tokenizer (adding ``<v>``) or a ready backend."""
    try:
        from transformers import PreTrainedTokenizerBase
        if isinstance(backend_or_hf, PreTrainedTokenizerBase):
            backend_or_hf.add_special_tokens(
                {"additional_special_tokens": [cfg.v_placeholder]})
            backend_or_hf.pad_token = backend_or_hf.eos_token
            backend_or_hf = HFBackend(backend_or_hf)
    except ImportError:
        pass
    return LiveTokenizer(backend_or_hf, cfg)
