"""Tokenizer front-end with pluggable backends.

Reproduces the reference's text contract (image_database.py:509-543):
  1. lowercase is mandatory,
  2. the prompt template is ``"this is a photo of {text}"``,
  3. padding to exactly 64 tokens (``max_length=64``).

The template/lowercasing live in :func:`build_prompt` (applied by the engine,
like the reference applies them before the processor call); this module turns
the prompt into fixed-length id arrays.

Backends, in resolution order:
  1. **SentencePieceBackend** — our pure-Python sentencepiece (tokenizer.model
     in the checkpoint dir). Family conventions: SigLIP2 uses the Gemma
     tokenizer (BOS prepended, no EOS); SigLIP1 appends EOS. Both pad right.
  2. **HFBackend** — transformers AutoTokenizer when importable and tokenizer
     files are present (bit-exact with upstream; useful where the full HF
     stack exists).
  3. **HashBackend** — deterministic word-hash ids for offline/random-weight
     smoke runs and tests; NOT compatible with pretrained checkpoints.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

MAX_LENGTH = 64  # strict SigLIP requirement (image_database.py:528)


def build_prompt(text: str) -> str:
    """Lowercase + official template (image_database.py:517-521)."""
    return f"this is a photo of {text.lower()}"


@dataclass(frozen=True)
class TokenizerConventions:
    add_bos: bool
    add_eos: bool
    pad_id: int
    canonicalize: bool = False  # SigLIP v1: strip punctuation pre-encode

    @staticmethod
    def for_model(model_name: str, sp_model=None) -> "TokenizerConventions":
        if "siglip2" in model_name:
            # Gemma tokenizer: BOS prepended, pad with <pad>=0, no
            # canonicalization.
            return TokenizerConventions(add_bos=True, add_eos=False, pad_id=0)
        # SigLIP v1 sentencepiece tokenizer: punctuation canonicalized away
        # (HF SiglipTokenizer.canonicalize_text, after big_vision's prompt
        # engineering), EOS appended. HF SiglipTokenizer hardcodes
        # pad_token="</s>" (= eos), IGNORING the spm proto's pad_id — the
        # c4/T5-style spm defines pad_id=0, and padding with it would put a
        # different token at the pooled last position (text_forward pools
        # hidden[:, -1, :]), diverging from the reference for every short
        # text. Always pad with eos.
        pad = sp_model.eos_id if sp_model is not None else 1
        return TokenizerConventions(add_bos=False, add_eos=True, pad_id=pad, canonicalize=True)


def canonicalize_text(text: str) -> str:
    """SigLIP v1 canonicalization: drop punctuation, collapse whitespace
    (matches HF SiglipTokenizer.canonicalize_text / big_vision)."""
    import re
    import string

    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text).strip()


class Tokenizer:
    """Fixed-length encoder.

    ``encode_with_mask`` returns (ids int32 [L], attention_mask int32 [L]) —
    the mask flags real tokens vs padding, and MUST be fed to the text tower
    (the reference's processor emits it and HF SiglipTextTransformer applies
    it; unmasked features diverge far beyond the 0.999-cosine budget).
    """

    vocab_size: int

    def encode_with_mask(self, text: str, max_length: int = MAX_LENGTH):
        raise NotImplementedError

    def encode(self, text: str, max_length: int = MAX_LENGTH) -> np.ndarray:
        return self.encode_with_mask(text, max_length)[0]

    def encode_batch(self, texts: Sequence[str], max_length: int = MAX_LENGTH) -> np.ndarray:
        return np.stack([self.encode(t, max_length) for t in texts])

    def encode_batch_with_mask(self, texts: Sequence[str], max_length: int = MAX_LENGTH):
        pairs = [self.encode_with_mask(t, max_length) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def _finalize(self, ids: List[int], conv: TokenizerConventions, max_length: int):
        if conv.add_bos:
            ids = [self.bos_id] + ids
        if conv.add_eos:
            # HF truncation reserves room for special tokens (prepare_for_model
            # truncates to max_length - 1 BEFORE appending eos), so the output
            # always ends with EOS — and the text tower pools the last
            # position. Truncate content, keep EOS.
            ids = ids + [self.eos_id]
            if len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_id]
        ids = ids[:max_length]
        out = np.full((max_length,), conv.pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        mask = np.zeros((max_length,), dtype=np.int32)
        mask[: len(ids)] = 1
        return out, mask


class SentencePieceBackend(Tokenizer):
    def __init__(self, model_file: str, model_name: str = ""):
        from tpuclip_torch.text.sentencepiece import load_model

        self.sp = load_model(model_file)
        self.vocab_size = self.sp.vocab_size
        self.bos_id = self.sp.bos_id
        self.eos_id = self.sp.eos_id
        self.conventions = TokenizerConventions.for_model(model_name, self.sp)

    def encode_with_mask(self, text: str, max_length: int = MAX_LENGTH):
        if self.conventions.canonicalize:
            text = canonicalize_text(text)
        ids = self.sp.encode(text)
        return self._finalize(list(ids), self.conventions, max_length)


class HFBackend(Tokenizer):
    def __init__(self, name_or_dir: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_dir)
        self.vocab_size = self.tok.vocab_size

    def encode_with_mask(self, text: str, max_length: int = MAX_LENGTH):
        out = self.tok(
            [text], padding="max_length", max_length=max_length, truncation=True
        )
        ids = np.asarray(out["input_ids"][0], dtype=np.int32)
        mask = np.asarray(
            out.get("attention_mask", [[1] * len(ids)])[0], dtype=np.int32
        )
        return ids, mask


class HashBackend(Tokenizer):
    """Deterministic whitespace-word hashing — stable ids for smoke/test runs."""

    def __init__(self, vocab_size: int = 256000):
        self.vocab_size = vocab_size
        self.bos_id = 2
        self.eos_id = 1
        self.conventions = TokenizerConventions(add_bos=True, add_eos=False, pad_id=0)

    def encode_with_mask(self, text: str, max_length: int = MAX_LENGTH):
        reserved = 3
        ids = []
        for word in text.lower().split():
            h = int.from_bytes(hashlib.sha256(word.encode("utf-8")).digest()[:8], "little")
            ids.append(reserved + (h % (self.vocab_size - reserved)))
        return self._finalize(ids, self.conventions, max_length)


def load_tokenizer(
    model_name: str,
    checkpoint_dir: Optional[str] = None,
    vocab_size: int = 256000,
) -> Tokenizer:
    """Resolve the best available backend for a checkpoint."""
    if checkpoint_dir:
        d = Path(checkpoint_dir)
        # SigLIP2/Gemma checkpoints ship "tokenizer.model"; SigLIP v1 ships
        # "spiece.model" (HF SiglipTokenizer.vocab_files_names) — check both.
        for sp_name in ("tokenizer.model", "spiece.model"):
            sp_file = d / sp_name
            if sp_file.exists():
                try:
                    return SentencePieceBackend(str(sp_file), model_name)
                except Exception as e:  # noqa: BLE001
                    print(f"Warning: sentencepiece load failed ({e}); trying HF tokenizer")
                break
        if (d / "tokenizer.json").exists() or (d / "tokenizer_config.json").exists():
            try:
                return HFBackend(str(d))
            except Exception as e:  # noqa: BLE001
                print(f"Warning: HF tokenizer load failed ({e}); using hash fallback")
    # Loud on purpose: hash ids are fine for smoke/tests but produce garbage
    # embeddings against PRETRAINED weights — this must never be a silent
    # downgrade (VERDICT r1 item 6).
    from tpuclip_torch.utils.logging import log

    log(
        f"  [WARNING] No tokenizer files found for {model_name or '<model>'}"
        + (f" under {checkpoint_dir}" if checkpoint_dir else " (no checkpoint dir)")
        + "; using the deterministic HASH tokenizer. Only valid for"
        " random-weight smoke runs — real checkpoints need tokenizer.model,"
        " spiece.model, or tokenizer.json beside the weights."
    )
    return HashBackend(vocab_size)
