"""A dependency-free byte-level tokenizer (port of trlx_tpu.utils.tokenizers).

`ByteTokenizer` gives the HF tokenizer surface the trainers use with no
vocab files, so tests and air-gapped runs need no download. Its ids are
0..257, a subset of any GPT-2-sized vocabulary.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Union


class ByteTokenizer:
    """UTF-8 byte tokenizer with bos/eos/pad specials.

    ids 0..255 = bytes; 256 = bos, 257 = eos; pad = eos (the gpt2
    convention).
    """

    vocab_size = 258

    def __init__(self, padding_side: str = "left", truncation_side: str = "right"):
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 257
        self.bos_token = "<|bos|>"
        self.eos_token = "<|eos|>"
        self.pad_token = self.eos_token
        self.name_or_path = "byte"

    def _encode_one(self, text: str, add_special_tokens: bool) -> List[int]:
        ids: List[int] = []
        rest = text
        if add_special_tokens and rest.startswith(self.bos_token):
            rest = rest[len(self.bos_token):]
            ids.append(self.bos_token_id)
        # specials spelled out in text are honored regardless
        while rest:
            nb = rest.find(self.bos_token)
            ne = rest.find(self.eos_token)
            cuts = [c for c in (nb, ne) if c != -1]
            cut = min(cuts) if cuts else len(rest)
            ids.extend(rest[:cut].encode("utf-8"))
            if cut == len(rest):
                break
            if cut == nb:
                ids.append(self.bos_token_id)
                rest = rest[cut + len(self.bos_token):]
            else:
                ids.append(self.eos_token_id)
                rest = rest[cut + len(self.eos_token):]
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._encode_one(text, add_special_tokens)

    def _truncate(self, ids: List[int], max_length: Optional[int]) -> List[int]:
        if max_length is None or len(ids) <= max_length:
            return ids
        if self.truncation_side == "left":
            return ids[-max_length:]
        return ids[:max_length]

    def __call__(
        self,
        text: Union[str, List[str]],
        truncation: bool = False,
        padding: Union[bool, str] = False,
        max_length: Optional[int] = None,
        add_special_tokens: bool = True,
        **_: Any,
    ) -> Dict[str, Any]:
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        enc = [self._encode_one(t, add_special_tokens) for t in texts]
        if truncation:
            enc = [self._truncate(ids, max_length) for ids in enc]
        if padding:
            width = max_length if padding == "max_length" and max_length else max(
                (len(x) for x in enc), default=0
            )
            enc, masks = self.pad_ids(enc, width)
        else:
            masks = [[1] * len(ids) for ids in enc]
        if single:
            return {"input_ids": enc[0], "attention_mask": masks[0]}
        return {"input_ids": enc, "attention_mask": masks}

    def pad_ids(self, seqs: List[List[int]], width: int):
        """Pad id lists to `width` honoring padding_side; over-long
        sequences are truncated from the configured truncation_side."""
        out, masks = [], []
        for ids in seqs:
            ids = self._truncate(list(ids), width)
            n = width - len(ids)
            if self.padding_side == "left":
                out.append([self.pad_token_id] * n + list(ids))
                masks.append([0] * n + [1] * len(ids))
            else:
                out.append(list(ids) + [self.pad_token_id] * n)
                masks.append([1] * len(ids) + [0] * n)
        return out, masks

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = ""
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i < 256:
                buf.append(i)
                continue
            out += buf.decode("utf-8", errors="replace")
            buf.clear()
            if not skip_special_tokens:
                out += self.bos_token if i == self.bos_token_id else self.eos_token
        out += buf.decode("utf-8", errors="replace")
        return out

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "ByteTokenizer"}, f)


def load_tokenizer(tokenizer_cfg) -> ByteTokenizer:
    """TokenizerConfig -> tokenizer: `tokenizer_path` "byte" or "char" gives
    the built-in ByteTokenizer; HF tokenizers are ROADMAP queue 7."""
    path = tokenizer_cfg.tokenizer_path
    if path not in ("byte", "char"):
        raise NotImplementedError(
            f"tokenizer_path={path!r} is not ported yet (ROADMAP queue 7: HF interop); "
            "use tokenizer_path='byte'"
        )
    return ByteTokenizer(
        padding_side=tokenizer_cfg.padding_side,
        truncation_side=tokenizer_cfg.truncation_side,
    )
