"""The tokenizer the benchmark hands the program, and its chat template.

Encoding is the port's ``ByteTokenizer``'s: ids 0-255 are bytes, then
``<bos>`` 256, ``<eos>`` 257 and ``<v>`` 258. The configurations' vocabularies
(32000, 152064) are far wider than that, so most ids a model emits have no
text in a byte tokenizer; ``decode`` therefore writes every id as ``<id>``,
special or not, and the served token ids can be read back from a response's
text (``ids_of``). The template strings are the live1+ template's, as the
serving engines build their prompts from it.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

SPECIALS = ("<bos>", "<eos>", "<v>")
BOS_ID, EOS_ID, V_ID = 256, 257, 258
INTERVAL = ","
STREAM_PROMPT = "\n["


def start_text(system_prompt: str) -> str:
    """The system message with the stream prompt, a dialogue's first ids."""
    return "<bos>" + system_prompt + "\n" + STREAM_PROMPT


def query_text(query: str) -> str:
    """A query asked while the stream is open, with the generation prompt."""
    return "]\nUser: " + query + "\nAssistant:"


GEN_PROMPT = "]\nAssistant:"


class IdTokenizer:
    """Byte-level encoding with lossless decoding (module docstring)."""

    bos_token, eos_token = "<bos>", "<eos>"

    def __init__(self):
        self._special_to_id = {t: 256 + i for i, t in enumerate(SPECIALS)}
        self._ordered = sorted(SPECIALS, key=len, reverse=True)

    def __len__(self) -> int:
        return 256 + len(SPECIALS)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special_to_id:
            return self._special_to_id[token]
        b = token.encode("utf-8")
        return b[0] if len(b) == 1 else None

    def encode_with_offsets(self, text: str
                            ) -> Tuple[List[int], List[Tuple[int, int]]]:
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        i = 0
        while i < len(text):
            sp = next((s for s in self._ordered if text.startswith(s, i)),
                      None)
            if sp is not None:
                ids.append(self._special_to_id[sp])
                offsets.append((i, i + len(sp)))
                i += len(sp)
                continue
            for byte in text[i].encode("utf-8"):
                ids.append(byte)
                offsets.append((i, i + 1))
            i += 1
        return ids, offsets

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False
               ) -> str:
        return "".join(f"<{int(t)}>" for t in ids)


def encode(text: str) -> List[int]:
    return IdTokenizer().encode_with_offsets(text)[0]


def ids_of(decoded: str) -> List[int]:
    """The ids ``IdTokenizer.decode`` wrote into ``decoded``."""
    return [int(x) for x in re.findall(r"<(\d+)>", decoded)]
