"""Self-contained SentencePiece implementation (no `sentencepiece` dependency).

The reference leans on HF transformers + the sentencepiece C++ library for
tokenization (requirements.txt:7, processor use at image_database.py:524).
This module reads a ``tokenizer.model`` (SentencePiece ModelProto, protobuf
wire format) directly and implements the two relevant encoding algorithms:

- **Unigram**: Viterbi segmentation maximizing the sum of piece log-probs.
- **BPE**: iterative highest-score adjacent merge (sentencepiece flavor where
  merge priority is the merged piece's score, ties broken left-first).

Normalization implemented: the model's ``precompiled_charsmap`` (a darts-clone
double-array trie of byte-sequence → replacement rules — the exact rules the
sentencepiece C++ normalizer applies, including its NFKC exceptions) when the
model carries one; plain NFKC via unicodedata as the fallback for
nmt/nfkc-named normalizers without a charsmap. Plus optional extra-whitespace
collapse, dummy-prefix insertion and whitespace escaping to ``▁`` (U+2581).
Byte-fallback (``<0xNN>`` pieces) is supported for out-of-vocab characters.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

# =============================================================================
# Protobuf wire-format primitives
# =============================================================================


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_num, wire_type = tag >> 3, tag & 0x7
        if wire_type == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire_type == 1:  # fixed64
            value = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire_type == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == 5:  # fixed32
            value = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wire_type}")
        yield field_num, wire_type, value


def _f32_from_bits(bits: int) -> float:
    import struct

    return struct.unpack("<f", bits.to_bytes(4, "little"))[0]


# =============================================================================
# precompiled_charsmap: darts-clone double-array trie of normalization rules
# =============================================================================


class PrecompiledCharsMap:
    """Reader for NormalizerSpec.precompiled_charsmap.

    Layout: ``<uint32 trie_bytes><darts-clone trie><replacement blob>``. Keys
    are UTF-8 source byte sequences; each leaf value is an offset into the
    replacement blob where the NUL-terminated normalized bytes live.

    darts-clone unit fields (uint32):
      label    = unit & 0x800000FF   (bit 31 poisons value-slot labels)
      has_leaf = (unit >> 8) & 1
      offset   = (unit >> 10) << ((unit & 0x200) >> 6)
      value    = unit & 0x7FFFFFFF   (on the label-0 child slot)
    """

    def __init__(self, blob: bytes):
        import struct

        import numpy as np

        (trie_bytes,) = struct.unpack("<I", blob[:4])
        self.trie = np.frombuffer(blob[4 : 4 + trie_bytes], dtype=np.uint32)
        self.replacements = blob[4 + trie_bytes :]

    def longest_match(self, data: bytes, start: int) -> Optional[Tuple[int, int]]:
        """Longest rule matching ``data[start:]`` → (byte_length, value)."""
        a = self.trie
        n = len(a)
        if n == 0:
            return None
        node_pos = self._offset(int(a[0]))
        best = None
        for i in range(start, len(data)):
            c = data[i]
            p = node_pos ^ c
            if p >= n:
                break
            unit = int(a[p])
            if (unit & 0x800000FF) != c:
                break
            node_pos = p ^ self._offset(unit)
            if (unit >> 8) & 1:
                best = (i + 1 - start, int(a[node_pos]) & 0x7FFFFFFF)
        return best

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def replacement(self, value: int) -> bytes:
        end = self.replacements.index(b"\0", value)
        return self.replacements[value:end]

    def normalize(self, text: str) -> str:
        """Longest-match rewrite (sentencepiece Normalizer::NormalizePrefix):
        at each position apply the longest matching rule, else copy one
        UTF-8 character verbatim."""
        data = text.encode("utf-8")
        out = bytearray()
        i = 0
        n = len(data)
        while i < n:
            m = self.longest_match(data, i)
            if m is not None:
                length, value = m
                out += self.replacement(value)
                i += length
            else:
                b = data[i]
                step = 4 if b >= 0xF0 else 3 if b >= 0xE0 else 2 if b >= 0xC0 else 1
                out += data[i : i + step]
                i += step
        return out.decode("utf-8", errors="replace")


def build_precompiled_charsmap(rules: Dict[str, str]) -> bytes:
    """Build a charsmap blob from {source: replacement} rules (test utility —
    real models ship theirs pre-built; this emits the same darts-clone layout
    PrecompiledCharsMap reads)."""
    import struct

    replacements = bytearray()
    root: Dict = {}
    node_values: Dict[int, int] = {}
    for src in sorted(rules):
        offset = len(replacements)
        replacements += rules[src].encode("utf-8") + b"\0"
        node = root
        for b in src.encode("utf-8"):
            node = node.setdefault(b, {})
        node_values[id(node)] = offset

    units: Dict[int, int] = {0: 0}
    used = {0}
    used_bases = set()

    def place(node: Dict, pos: int) -> None:
        labels = sorted(node)
        has_val = id(node) in node_values
        base = 1
        while True:
            # Bases must be globally unique: traversal's only guard is the
            # label check, and two nodes sharing a base would alias each
            # other's children at base ^ label.
            slots = [base ^ l for l in labels] + ([base] if has_val else [])
            if base not in used_bases and all(s and s not in used for s in slots):
                break
            base += 1
        used.update(slots)
        used_bases.add(base)
        offset = pos ^ base
        if offset >= 1 << 21:  # keep the plain (unshifted) offset encoding
            raise ValueError("charsmap trie too large for the test builder")
        units[pos] = units.get(pos, 0) | (offset << 10)
        if has_val:
            units[base] = node_values[id(node)] | 0x80000000
        for l in labels:
            child_pos = base ^ l
            unit = l
            if id(node[l]) in node_values:
                unit |= 0x100
            units[child_pos] = unit
            place(node[l], child_pos)

    place(root, 0)
    # darts-clone allocates the double-array in 256-unit blocks, so readers
    # may probe base ^ label (label <= 0xFF) WITHOUT a bounds check — the
    # Rust spm_precompiled reader panics on a short array (found by the
    # tokenizers-oracle test with a 4-byte UTF-8 lead byte). Pad to the
    # block boundary; padding units are 0 (label 0 ≠ any probe byte).
    size = -(-(max(units) + 1) // 256) * 256
    trie = bytearray(size * 4)
    for p, u in units.items():
        trie[p * 4 : p * 4 + 4] = struct.pack("<I", u)
    return struct.pack("<I", len(trie)) + bytes(trie) + bytes(replacements)


# =============================================================================
# ModelProto parsing (sentencepiece_model.proto field numbers)
# =============================================================================

# SentencePiece.Type enum
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

# ModelType enum
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


@dataclass
class SentencePieceModel:
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    normalizer_name: str = "nmt_nfkc"
    byte_fallback: bool = False
    precompiled_charsmap: bytes = b""

    # Derived lookup structures (built in __post_init__ / finalize)
    piece_to_id: Dict[str, int] = field(default_factory=dict)
    _byte_ids: Dict[int, int] = field(default_factory=dict)
    _max_piece_len: int = 1
    charsmap: Optional[PrecompiledCharsMap] = None

    def finalize(self) -> "SentencePieceModel":
        self.charsmap = (
            PrecompiledCharsMap(self.precompiled_charsmap)
            if self.precompiled_charsmap
            else None
        )
        self.piece_to_id = {}
        for i, p in enumerate(self.pieces):
            # first occurrence wins (duplicate pieces are possible for control)
            self.piece_to_id.setdefault(p, i)
            if self.types[i] == _BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        self._max_piece_len = max((len(p) for p in self.pieces), default=1)
        return self

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ---------------------------------------------------------- normalization

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            # The model's own precompiled rules (NFKC + its exceptions).
            text = self.charsmap.normalize(text)
        elif "nfkc" in self.normalizer_name:
            text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", "▁")
        return text

    # --------------------------------------------------------------- encoding

    def encode(self, text: str, out_type: str = "id") -> List:
        """Encode normalized text to piece ids (or pieces)."""
        norm = self.normalize(text)
        if not norm:
            return []
        if self.model_type == BPE:
            pieces = self._encode_bpe(norm)
        else:
            pieces = self._encode_unigram(norm)
        if out_type == "piece":
            return pieces
        return self._pieces_to_ids(pieces)

    def _pieces_to_ids(self, pieces: List[str]) -> List[int]:
        ids: List[int] = []
        last_unknown = False
        for p in pieces:
            pid = self.piece_to_id.get(p)
            if pid is not None and self.types[pid] != _UNUSED:
                ids.append(pid)
                last_unknown = False
                continue
            if self.byte_fallback:
                for b in p.encode("utf-8"):
                    ids.append(self._byte_ids.get(b, self.unk_id))
                last_unknown = False
            else:
                # sentencepiece fuses consecutive unknown pieces into ONE
                # <unk> (HF's SpmConverter mirrors this as fuse_unk=True);
                # one id per unknown char would diverge from the canonical
                # tokenizer on unknown runs.
                if not last_unknown:
                    ids.append(self.unk_id)
                last_unknown = True
        return ids

    def _encode_unigram(self, text: str) -> List[str]:
        """Viterbi over the piece lattice (max total log-prob)."""
        n = len(text)
        NEG = -1e18
        best: List[float] = [NEG] * (n + 1)
        back: List[Tuple[int, Optional[str]]] = [(-1, None)] * (n + 1)
        best[0] = 0.0
        p2i = self.piece_to_id
        maxlen = self._max_piece_len
        unk_penalty = min(self.scores) - 10.0 if self.scores else -20.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            matched = False
            limit = min(n, i + maxlen)
            for j in range(i + 1, limit + 1):
                piece = text[i:j]
                pid = p2i.get(piece)
                if pid is None:
                    continue
                t = self.types[pid]
                # Only NORMAL and USER_DEFINED pieces are matchable in text
                # (sentencepiece builds its matcher trie from those alone);
                # control/byte pieces must never match their literal spelling.
                if t in (_UNKNOWN, _UNUSED, _CONTROL, _BYTE):
                    continue
                score = best[i] + self.scores[pid]
                if score > best[j]:
                    best[j] = score
                    back[j] = (i, piece)
                matched = True
            # unknown single character fallback keeps the lattice connected
            if not matched or best[i + 1] <= NEG / 2:
                score = best[i] + unk_penalty
                if score > best[i + 1]:
                    best[i + 1] = score
                    back[i + 1] = (i, text[i : i + 1])
        pieces: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            pieces.append(piece or text[i:j])
            j = i
        pieces.reverse()
        return pieces

    def _encode_bpe(self, text: str) -> List[str]:
        """Greedy merges by merged-piece score (sentencepiece BPE)."""
        symbols = list(text)
        if not symbols:
            return []
        p2i = self.piece_to_id
        while True:
            best_score = None
            best_idx = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                pid = p2i.get(merged)
                if pid is None or self.types[pid] in (_UNKNOWN, _UNUSED, _CONTROL, _BYTE):
                    continue
                s = self.scores[pid]
                if best_score is None or s > best_score:
                    best_score = s
                    best_idx = i
            if best_idx < 0:
                break
            symbols[best_idx : best_idx + 2] = [symbols[best_idx] + symbols[best_idx + 1]]
        return symbols


def parse_model(data: bytes) -> SentencePieceModel:
    """Parse a serialized ModelProto."""
    m = SentencePieceModel()
    for fnum, wtype, value in _iter_fields(data):
        if fnum == 1 and wtype == 2:  # SentencePiece pieces
            piece, score, ptype = "", 0.0, _NORMAL
            for pf, pw, pv in _iter_fields(value):
                if pf == 1:
                    piece = pv.decode("utf-8")
                elif pf == 2 and pw == 5:
                    score = _f32_from_bits(pv)
                elif pf == 3:
                    ptype = pv
            m.pieces.append(piece)
            m.scores.append(score)
            m.types.append(ptype)
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for tf, _, tv in _iter_fields(value):
                if tf == 3:
                    m.model_type = tv
                elif tf == 35:
                    m.byte_fallback = bool(tv)
                elif tf == 40:
                    m.unk_id = tv
                elif tf == 41:
                    m.bos_id = _signed(tv)
                elif tf == 42:
                    m.eos_id = _signed(tv)
                elif tf == 43:
                    m.pad_id = _signed(tv)
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for nf, _, nv in _iter_fields(value):
                if nf == 1:
                    m.normalizer_name = nv.decode("utf-8")
                elif nf == 2:
                    m.precompiled_charsmap = nv
                elif nf == 3:
                    m.add_dummy_prefix = bool(nv)
                elif nf == 4:
                    m.remove_extra_whitespaces = bool(nv)
                elif nf == 5:
                    m.escape_whitespaces = bool(nv)
    return m.finalize()


def _signed(v: int) -> int:
    """Protobuf int32 negative values arrive as 64-bit two's complement varints."""
    if v >= 1 << 63:
        return v - (1 << 64)
    if v >= 1 << 31:
        return v - (1 << 32)
    return v


def load_model(path: str) -> SentencePieceModel:
    with open(path, "rb") as f:
        return parse_model(f.read())


# =============================================================================
# Serialization (for tests: build a tiny model file without sentencepiece)
# =============================================================================


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wtype: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wtype) + payload


def serialize_model(m: SentencePieceModel) -> bytes:
    """Serialize to ModelProto wire format (subset round-trippable by parse_model)."""
    import struct

    out = bytearray()
    for piece, score, ptype in zip(m.pieces, m.scores, m.types):
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _field(1, 2, _varint(len(pb)) + pb)
        body += _field(2, 5, struct.pack("<f", score))
        body += _field(3, 0, _varint(ptype))
        out += _field(1, 2, _varint(len(body)) + bytes(body))
    trainer = bytearray()
    trainer += _field(3, 0, _varint(m.model_type))
    trainer += _field(35, 0, _varint(int(m.byte_fallback)))
    for num, vid in ((40, m.unk_id), (41, m.bos_id), (42, m.eos_id), (43, m.pad_id)):
        trainer += _field(num, 0, _varint(vid & 0xFFFFFFFFFFFFFFFF if vid < 0 else vid))
    out += _field(2, 2, _varint(len(trainer)) + bytes(trainer))
    norm = bytearray()
    nb = m.normalizer_name.encode("utf-8")
    norm += _field(1, 2, _varint(len(nb)) + nb)
    if m.precompiled_charsmap:
        norm += _field(2, 2, _varint(len(m.precompiled_charsmap)) + m.precompiled_charsmap)
    norm += _field(3, 0, _varint(int(m.add_dummy_prefix)))
    norm += _field(4, 0, _varint(int(m.remove_extra_whitespaces)))
    norm += _field(5, 0, _varint(int(m.escape_whitespaces)))
    out += _field(3, 2, _varint(len(norm)) + bytes(norm))
    return bytes(out)
