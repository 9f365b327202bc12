"""Tokenizers for the LM daemon's text front (port of
dnn_tpu/io/tokenizer.py).

Two implementations of one protocol (`encode(str) -> list[int]`,
`decode(ids) -> str`):

  * `ByteTokenizer` — UTF-8 bytes as ids (plus an optional offset), for
    any model with vocab_size >= 256; exact round trip, no vocab files.
  * `load_hf_tokenizer(path)` — an adapter over a LOCAL HuggingFace
    tokenizer directory (`local_files_only`: a hub name is never
    fetched). `transformers` is imported inside it, so the module
    imports where that package is absent.

`stream_detokenizer` gives the incremental decoder a streaming client
needs: its chunks joined equal the one-shot decode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["ByteTokenizer", "StreamingDetokenizer",
           "stream_detokenizer", "hf_vocab_bytes", "load_hf_tokenizer"]


class ByteTokenizer:
    """UTF-8 bytes as token ids, shifted by `offset`.

    Round-trips any text exactly (decode(encode(s)) == s). Ids outside
    [offset, offset+256) decode to the replacement character rather than
    raising — generated ids come from a model that does not know byte
    boundaries, and a text endpoint must not 500 on them."""

    def __init__(self, vocab_size: int, *, offset: int = 0):
        if vocab_size < offset + 256:
            raise ValueError(
                f"byte tokenizer needs vocab_size >= offset+256, got "
                f"{vocab_size} (offset {offset})")
        self.vocab_size = vocab_size
        self.offset = offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        raw = bytearray()
        for i in ids:
            j = int(i) - self.offset
            if 0 <= j < 256:
                raw.append(j)
            else:
                raw += b"\xef\xbf\xbd"  # U+FFFD, as documented — never a
                # fabricated 0x00/0xFF byte
        return bytes(raw).decode("utf-8", errors="replace")

    def vocab_bytes(self, vocab_size: Optional[int] = None) -> List[bytes]:
        """Token id -> the bytes that token emits (the vocab map of
        constrained decoding); ids outside the byte range map to b"".
        Pass the MODEL's `vocab_size` when it differs (a padded embedding
        table)."""
        size = vocab_size or self.vocab_size
        return [bytes([i - self.offset])
                if self.offset <= i < self.offset + 256 else b""
                for i in range(size)]


def _utf8_complete_prefix(b) -> int:
    """Length of the longest prefix of `b` that ends on a UTF-8 sequence
    boundary — the split point at which chunked decoding equals whole
    -buffer decoding. Only a trailing INCOMPLETE sequence (a lead byte
    still waiting for continuation bytes) is held back; orphan
    continuation bytes and invalid leads can never become valid later,
    so they flow through (decoded to U+FFFD, exactly as a one-shot
    decode would)."""
    n = len(b)
    i, k = n - 1, 0
    while i >= 0 and k < 3 and (b[i] & 0xC0) == 0x80:
        i -= 1
        k += 1
    if i < 0:
        return n  # nothing but continuations — invalid either way
    lead = b[i]
    if lead >= 0xF0:
        need = 4
    elif lead >= 0xE0:
        need = 3
    elif lead >= 0xC0:
        need = 2
    else:
        need = 1  # ASCII or invalid lead — complete at this byte
    return i if i + need > n else n


class _ByteStreamingDetokenizer:
    """Byte-exact incremental detokenizer for ByteTokenizer streams:
    O(1) per token, emits only complete UTF-8 sequences (a multi-byte
    character split across tokens never surfaces as partial garbage).
    Invariant: ``"".join(push(t) for t) + flush() == tok.decode(ids)``
    byte-for-byte (tests/test_torch_tokenizer.py)."""

    def __init__(self, tok: "ByteTokenizer"):
        self._tok = tok
        self._buf = bytearray()

    def push(self, token_id: int) -> str:
        j = int(token_id) - self._tok.offset
        if 0 <= j < 256:
            self._buf.append(j)
        else:
            self._buf += b"\xef\xbf\xbd"  # U+FFFD, as decode() does
        cut = _utf8_complete_prefix(self._buf)
        if cut == 0:
            return ""
        chunk = bytes(self._buf[:cut]).decode("utf-8", errors="replace")
        del self._buf[:cut]
        return chunk

    def flush(self) -> str:
        chunk = bytes(self._buf).decode("utf-8", errors="replace")
        self._buf.clear()
        return chunk


class StreamingDetokenizer:
    """Tokenizer-agnostic incremental detokenizer: works over anything
    with ``decode(ids) -> str`` (the HF adapter included, whose BPE
    pieces may be partial UTF-8 sequences).

    Strategy (the HF TextStreamer construction): keep all ids, decode
    the full stream, emit the text that GREW since the last emission —
    holding back whenever the decode ends in U+FFFD, because a later
    token may complete the partial character (a genuine replacement
    character is released by the next clean decode, or by flush()).
    Cost is O(n) decode per token (O(n^2) per stream) — bounded by
    max_new_tokens; use ByteTokenizer's byte-exact streamer (via
    `stream_detokenizer`) for the O(n) path.

    Invariant: ``"".join(chunks) + flush() == decode(all_ids)`` for any
    PREFIX-MONOTONE decode (decode(ids + [t]) extends decode(ids)) —
    true of byte-concatenation decoders (byte-level BPE, ByteTokenizer,
    this module's HF adapter). A non-monotone decode (e.g. HF
    clean_up_tokenization_spaces collapsing "word " + "." -> "word.")
    cannot stream exactly — emitted text can never be retracted; this
    class detects the prefix violation, stops emitting, and lets
    flush() emit everything past the longest common prefix (no
    duplicated characters, possibly a small divergence at the
    boundary)."""

    def __init__(self, tok):
        self._tok = tok
        self._ids: List[int] = []
        self._done = ""  # text already yielded

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        text = self._tok.decode(self._ids)
        if text.endswith("�"):
            return ""  # possibly a split multi-byte piece — wait
        if not text.startswith(self._done):
            return ""  # non-monotone decode — hold for flush()
        chunk = text[len(self._done):]
        self._done = text
        return chunk

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        if text.startswith(self._done):
            chunk = text[len(self._done):]
        else:
            n = 0  # longest common prefix with what already went out
            for a, b in zip(text, self._done):
                if a != b:
                    break
                n += 1
            chunk = text[n:]
        self._done = text
        return chunk


def stream_detokenizer(tok):
    """The right incremental detokenizer for `tok`: byte-exact O(1)/token
    for ByteTokenizer, decode-diff for everything else."""
    if isinstance(tok, ByteTokenizer):
        return _ByteStreamingDetokenizer(tok)
    return StreamingDetokenizer(tok)


def _byte_level_alphabet():
    """The GPT-2 byte-level BPE printable-alias table: byte value ->
    the unicode char that stands for it inside vocab token STRINGS
    (the public bytes_to_unicode construction — printable bytes map to
    themselves, the rest to 256+n aliases)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def hf_vocab_bytes(tok, vocab_size: Optional[int] = None) -> List[bytes]:
    """Best-effort token-id -> EMITTED-BYTES map for a HuggingFace
    tokenizer — the vocab map constrained decoding needs for real
    BPE/SentencePiece models, where one token is several bytes.

    Handles the two dominant conventions, DETECTED ONCE PER VOCAB (a
    per-token guess would mis-decode SentencePiece pieces that happen to
    consist of alias-alphabet chars — 'é' must become its UTF-8 bytes,
    not the Latin-1 byte the alias table maps it to):
      * SentencePiece (LLaMA family) — any '▁'-marked or '<0xNN>' piece
        in the vocab: '▁' prefixes a space, '<0xNN>' pieces are raw
        bytes, everything else is UTF-8 text;
      * otherwise byte-level BPE (GPT-2/RoBERTa family): vocab strings
        use the bytes_to_unicode alias alphabet, inverted char-by-char.
    Special tokens and anything unmappable map to b"" (banned by the
    constraint engine — a grammar can never need them; EOS is handled
    separately by mask_row). Pass the MODEL's `vocab_size` when its
    embedding table is padded past the tokenizer vocab — the padding ids
    map to b"".

    Known best-effort divergence (SentencePiece): '▁' is mapped to a
    space UNCONDITIONALLY, but SP detokenization strips the leading
    space of the FIRST piece — so a '▁'-prefixed token at position 0
    contributes b" x..." here while the decoded text starts with "x...".
    A grammar anchored at string start therefore cannot be satisfied by
    '▁'-prefixed first tokens even when the decoded text would match;
    write such grammars to tolerate one leading space (e.g. prefix with
    ' ?'), or serve byte-level vocabs where the map is exact."""
    vocab = tok.get_vocab()  # {token_string: id}
    size = vocab_size or max(vocab.values()) + 1
    out = [b""] * size
    specials = set(getattr(tok, "all_special_tokens", []) or [])

    def _is_byte_piece(s):
        return s.startswith("<0x") and s.endswith(">") and len(s) == 6

    sentencepiece = any("▁" in s or _is_byte_piece(s) for s in vocab)
    alias = None if sentencepiece else _byte_level_alphabet()
    for s, tid in vocab.items():
        if tid >= size or s in specials:
            continue
        if sentencepiece:
            if _is_byte_piece(s):
                try:
                    out[tid] = bytes([int(s[3:5], 16)])
                except ValueError:
                    pass
                continue
            out[tid] = s.replace("▁", " ").encode("utf-8")
        elif all(ch in alias for ch in s):
            out[tid] = bytes(alias[ch] for ch in s)
        # non-alias strings in a byte-level vocab (added specials) stay b""
    return out


def load_hf_tokenizer(path: str):
    """Adapter over a local HF tokenizer directory: returns an object with
    the same encode/decode protocol (no special tokens added on encode;
    specials skipped on decode — the daemon serves raw continuations),
    plus `vocab_bytes()`, the token -> bytes map over the real vocab."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    class _HF:
        vocab_size = tok.vocab_size

        @staticmethod
        def encode(text: str) -> List[int]:
            return tok.encode(text, add_special_tokens=False)

        @staticmethod
        def decode(ids: Sequence[int]) -> str:
            return tok.decode(list(ids), skip_special_tokens=True)

        @staticmethod
        def vocab_bytes(vocab_size: Optional[int] = None) -> List[bytes]:
            return hf_vocab_bytes(tok, vocab_size)

    return _HF()
