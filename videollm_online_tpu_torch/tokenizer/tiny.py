"""Self-contained byte-level tokenizer for tests and offline development.

No network, no vocab files: ids 0-255 are raw bytes; special tokens (matched
greedily, longest-first) get ids from 256 up, with ``<v>`` installed as the
**last** id to mirror the reference's "placeholder id = len(tokenizer)-1 is
out of the embedding table" property (tokenization_live.py:112-113,
modeling_live.py:38).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class ByteTokenizer:
    def __init__(self, special_tokens: Sequence[str] = ("<bos>", "<eos>"),
                 v_placeholder: str = "<v>"):
        self.bos_token = special_tokens[0]
        self.eos_token = special_tokens[1]
        specials = list(special_tokens) + [v_placeholder]
        self._special_to_id = {t: 256 + i for i, t in enumerate(specials)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        # longest-first greedy matching
        self._ordered = sorted(specials, key=len, reverse=True)

    def __len__(self):
        return 256 + len(self._special_to_id)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special_to_id:
            return self._special_to_id[token]
        b = token.encode("utf-8")
        return b[0] if len(b) == 1 else None

    def encode_with_offsets(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for sp in self._ordered:
                if text.startswith(sp, i):
                    ids.append(self._special_to_id[sp])
                    offsets.append((i, i + len(sp)))
                    i += len(sp)
                    matched = True
                    break
            if not matched:
                b = text[i].encode("utf-8")
                for byte in b:
                    ids.append(byte)
                    offsets.append((i, i + 1))
                i += 1
        return ids, offsets

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for t in ids:
            t = int(t)
            if t >= 256:
                flush()
                if not skip_special_tokens:
                    out.append(self._id_to_special.get(t, ""))
            else:
                buf.append(t)
        flush()
        return "".join(out)
