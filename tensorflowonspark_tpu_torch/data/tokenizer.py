"""Deterministic, dependency-free tokenizers for the text plane.

The text plane (:mod:`~tensorflowonspark_tpu_torch.data.text_plane`) needs three
things from a tokenizer, and nothing else:

1. a **cheap validating length** — :meth:`Tokenizer.token_length` tells the
   packer how many slots a record will occupy *before* anything is encoded,
   and it is the single place malformed input is rejected (not UTF-8, empty
   text, missing TFRecord feature). Because the packer calls it in the
   producer thread in every mode, the ``max_bad_records`` budget accounting
   is identical across thread and process packing — mode-invariant by
   construction.
2. a **deterministic encode** — :meth:`Tokenizer.encode` maps the same
   record bytes to the same ``int32`` ids everywhere (producer thread,
   forked pack worker, warm cache run), so the delivered ``[B, L]`` stream
   is byte-identical across worker counts and cache states.
3. a **config fingerprint** — :attr:`Tokenizer.cache_key` scopes the
   JAX package's packed-slab cache (not yet ported) so a vocab or kind
   change can never serve stale token rows.

Two tokenizer kinds cover the subsystem without pulling in a vocab file
dependency (the container has none):

- ``"byte"`` — one token per UTF-8 byte, offset past the reserved ids.
  Lossless, vocabulary 259, the ByT5 shape (Xue et al. 2022).
- ``"word"`` — whitespace words hashed onto a fixed table with crc32
  ("feature hashing"); lossy but realistic LM lengths for benchmarks.

Ids ``0/1/2`` are reserved as ``PAD/BOS/EOS`` in both kinds; every encoded
sequence is ``[BOS] + body + [EOS]`` and truncation keeps the terminal EOS.

Records are raw text bytes by default; with ``field="name"`` the record is
a serialized TFRecord ``Example`` (the shape :meth:`TFEstimator
<tensorflowonspark_tpu_torch.pipeline.TFEstimator>` materializes via
``setTFRecordDir``) and the named bytes feature is extracted first.
"""

import zlib

import numpy as np

__all__ = [
    "PAD_ID",
    "BOS_ID",
    "EOS_ID",
    "RESERVED_IDS",
    "TokenizeError",
    "Tokenizer",
    "make_pack_fn",
    "write_segment",
]

#: reserved special ids shared by every tokenizer kind
PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
#: first id available to real tokens
RESERVED_IDS = 3

#: vocabulary a byte tokenizer always has: 256 byte values + reserved ids
BYTE_VOCAB = 256 + RESERVED_IDS


class TokenizeError(ValueError):
    """A record the tokenizer refuses: not valid UTF-8, empty text, or a
    TFRecord Example missing the configured text feature. Charged against
    the pipeline's ``max_bad_records`` budget like an undecodable JPEG."""


class Tokenizer:
    """Config + pure functions; safe to share across threads and to
    inherit into forked pack workers (no open handles, no RNG state).

    Parameters
    ----------
    kind:
        ``"byte"`` (default) or ``"word"``.
    vocab_size:
        Id-space size. Byte kind requires >= 259 (default exactly 259);
        word kind hashes words onto ``vocab_size - 3`` buckets (default
        32768).
    field:
        When set, records are serialized TFRecord ``Example`` protos and
        the text lives in this bytes feature (the ``dfutil`` /
        ``setTFRecordDir`` materialization shape). When None (default),
        records are the raw UTF-8 text bytes themselves.
    """

    def __init__(self, kind="byte", vocab_size=None, field=None):
        if kind not in ("byte", "word"):
            raise ValueError("kind must be 'byte' or 'word', got {!r}".format(kind))
        self.kind = kind
        if vocab_size is None:
            vocab_size = BYTE_VOCAB if kind == "byte" else 32768
        vocab_size = int(vocab_size)
        if kind == "byte" and vocab_size < BYTE_VOCAB:
            raise ValueError(
                "byte tokenizer needs vocab_size >= {} (got {})".format(
                    BYTE_VOCAB, vocab_size
                )
            )
        if kind == "word" and vocab_size <= RESERVED_IDS:
            raise ValueError("word tokenizer needs vocab_size > 3")
        self.vocab_size = vocab_size
        self.field = field

    # -- config fingerprint -------------------------------------------------

    @property
    def cache_key(self):
        """Scopes the packed-slab cache: any config change re-keys it."""
        return "text:{}:v{}:f{}".format(self.kind, self.vocab_size, self.field or "-")

    # -- validation + length ------------------------------------------------

    def _text_bytes(self, rec):
        """Raw UTF-8 text bytes of ``rec`` (after Example extraction when
        ``field`` is set). Raises :class:`TokenizeError` on anything that
        is not a non-empty, valid-UTF-8 text record."""
        raw = bytes(rec)
        if self.field is not None:
            from tensorflowonspark_tpu_torch import tfrecord

            try:
                feats = tfrecord.decode_example(raw)
            except Exception as e:
                raise TokenizeError("record is not a TFRecord Example: {}".format(e))
            got = feats.get(self.field)
            if got is None or got[0] != "bytes" or not got[1]:
                raise TokenizeError(
                    "Example has no bytes feature {!r} (features: {})".format(
                        self.field, sorted(feats)
                    )
                )
            raw = got[1][0]
        try:
            text = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise TokenizeError("record is not valid UTF-8: {}".format(e))
        if not text.strip():
            raise TokenizeError("empty text record")
        return raw

    def token_length(self, rec):
        """Untruncated token count of ``rec`` (BOS and EOS included)
        without building the id array — the packer's planning primitive.
        Raises :class:`TokenizeError` for malformed records, so budget
        accounting happens here, producer-side, in every pack mode."""
        raw = self._text_bytes(rec)
        if self.kind == "byte":
            return len(raw) + 2
        return len(raw.split()) + 2

    # -- encoding ------------------------------------------------------------

    def encode(self, rec, max_tokens=None):
        """``rec`` -> ``int32 [n]`` ids: ``[BOS] + body + [EOS]``; with
        ``max_tokens`` the body is truncated so ``n <= max_tokens`` and the
        terminal EOS survives (a truncated sequence still ends)."""
        raw = self._text_bytes(rec)
        if self.kind == "byte":
            body = np.frombuffer(raw, np.uint8).astype(np.int32) + RESERVED_IDS
        else:
            buckets = self.vocab_size - RESERVED_IDS
            body = np.fromiter(
                (RESERVED_IDS + zlib.crc32(w) % buckets for w in raw.split()),
                np.int32,
            )
        ids = np.empty(len(body) + 2, np.int32)
        ids[0] = BOS_ID
        ids[1:-1] = body
        ids[-1] = EOS_ID
        if max_tokens is not None and len(ids) > max_tokens:
            ids = ids[:max_tokens].copy()
            ids[-1] = EOS_ID
        return ids


def write_segment(row, offset, seg_id, ids):
    """Land one packed sequence into a ``[3, L]`` row at ``offset``:
    plane 0 = token ids, plane 1 = segment id (0 marks padding), plane 2 =
    positions restarting at 0 per segment (rotary phase must not leak
    across pack neighbours). Shared by the thread path and the forked
    pack workers — one writer, one byte layout."""
    n = len(ids)
    row[0, offset : offset + n] = ids
    row[1, offset : offset + n] = seg_id
    row[2, offset : offset + n] = np.arange(n, dtype=np.int32)


def make_pack_fn(tokenizer, seq_len):
    """Build the pack-plane ``parse_fn`` for :class:`~tensorflowonspark_tpu_torch.
    data.text_plane.TextPipeline`.

    The decode plane's lease protocol ships an arbitrary picklable payload
    per slot; here the payload is a *pack plan* — a tuple of
    ``(offset, seg_id, eff_len, record_bytes)`` segments the producer could
    not serve from the packed-slab cache. ``.into(plan, row)`` tokenizes
    each segment and writes it at its planned offset via
    :func:`write_segment`; writes are deterministic and confined to the
    planned ranges, so a re-leased slot (worker death) simply rewrites the
    same bytes and the producer's own parent-side writes (zeroing, cache
    hits) are never touched.

    Returns a closure with the loader's parse-fn attributes: ``into``,
    ``cache_key`` (tokenizer fingerprint + ``seq_len``, because truncation
    depends on the bin capacity) and ``seq_len``.
    """
    seq_len = int(seq_len)

    def into(plan, row):
        for offset, seg_id, eff_len, rec in plan:
            write_segment(row, offset, seg_id, tokenizer.encode(rec, eff_len))
        return len(plan), False

    def pack_fn(plan):
        row = np.zeros((3, seq_len), np.int32)
        n, _ = into(plan, row)
        return row, n

    pack_fn.into = into
    pack_fn.cache_key = "{}:L{}".format(tokenizer.cache_key, seq_len)
    pack_fn.seq_len = seq_len
    pack_fn.tokenizer = tokenizer
    return pack_fn
