"""The port's tokenizers against the JAX package's (dnn_tpu/io/
tokenizer.py): ByteTokenizer and the streaming detokenizers over UTF-8
text (hypothesis), multi-byte pieces and non-monotone decodes (the cases
of tests/test_tokenizer.py), and the HuggingFace adapter on a byte-level
BPE built in a tmp dir (no download). Every comparison is exact."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dnn_tpu.io import tokenizer as jtok
from dnn_tpu_torch.io import tokenizer as ttok

SETTINGS = settings(max_examples=60, deadline=None)


def _streamed(det, ids):
    chunks = [det.push(i) for i in ids]
    return chunks, det.flush()


@SETTINGS
@given(text=st.text(), offset=st.sampled_from([0, 2, 40]))
def test_byte_tokenizer_equals_jax(text, offset):
    mine = ttok.ByteTokenizer(300 + offset, offset=offset)
    theirs = jtok.ByteTokenizer(300 + offset, offset=offset)
    ids = mine.encode(text)
    assert ids == theirs.encode(text)
    assert mine.decode(ids) == theirs.decode(ids) == text
    assert mine.vocab_bytes() == theirs.vocab_bytes()
    assert mine.vocab_bytes(512) == theirs.vocab_bytes(512)


@SETTINGS
@given(ids=st.lists(st.integers(0, 299), max_size=40))
def test_out_of_range_ids_decode_to_replacement_like_jax(ids):
    mine, theirs = ttok.ByteTokenizer(300, offset=2), \
        jtok.ByteTokenizer(300, offset=2)
    assert mine.decode(ids) == theirs.decode(ids)
    assert mine.decode([0, 1, 299, 2 + ord("a")]) == "�" * 3 + "a"


def test_byte_tokenizer_refuses_a_small_vocab():
    with pytest.raises(ValueError, match="vocab_size"):
        ttok.ByteTokenizer(100)


@SETTINGS
@given(data=st.binary(max_size=24))
def test_utf8_complete_prefix_equals_jax(data):
    assert ttok._utf8_complete_prefix(data) == \
        jtok._utf8_complete_prefix(data)


@SETTINGS
@given(text=st.text(), extra=st.lists(st.integers(0, 299), max_size=6))
def test_byte_streamer_equals_jax_and_the_one_shot_decode(text, extra):
    mine, theirs = ttok.ByteTokenizer(300, offset=2), \
        jtok.ByteTokenizer(300, offset=2)
    ids = mine.encode(text) + extra
    got = _streamed(ttok.stream_detokenizer(mine), ids)
    assert got == _streamed(jtok.stream_detokenizer(theirs), ids)
    assert "".join(got[0]) + got[1] == mine.decode(ids)


def test_byte_streamer_holds_a_split_character():
    tok = ttok.ByteTokenizer(300, offset=2)
    e_ids = tok.encode("🙂")
    det = ttok.stream_detokenizer(tok)
    assert [det.push(i) for i in e_ids[:-1]] == ["", "", ""]
    assert det.push(e_ids[-1]) == "🙂"


_PIECES = [b"a", b"\xf0\x9f", b"\x98\x80", b" ok", b"\xc3", b"\xa9", b"."]


class _Pieces:
    """A vocab whose pieces split characters across tokens."""

    @staticmethod
    def decode(ids):
        return b"".join(_PIECES[i] for i in ids).decode("utf-8",
                                                        errors="replace")


class _Cleanup:
    """A non-monotone decode: 'word ' + '.' collapses to 'word.'."""

    @staticmethod
    def decode(ids):
        return "".join(["word ", "."][i] for i in ids).replace(" .", ".")


@SETTINGS
@given(ids=st.lists(st.integers(0, len(_PIECES) - 1), max_size=20))
def test_generic_streamer_on_multibyte_pieces_equals_jax(ids):
    got = _streamed(ttok.StreamingDetokenizer(_Pieces()), ids)
    assert got == _streamed(jtok.StreamingDetokenizer(_Pieces()), ids)
    assert "".join(got[0]) + got[1] == _Pieces.decode(ids)


@pytest.mark.parametrize("ids", [[0, 1], [0, 1, 0, 1], [1, 0, 1], [0, 0, 1]])
def test_generic_streamer_on_a_non_monotone_decode_equals_jax(ids):
    got = _streamed(ttok.StreamingDetokenizer(_Cleanup()), ids)
    assert got == _streamed(jtok.StreamingDetokenizer(_Cleanup()), ids)
    out = "".join(got[0]) + got[1]
    assert out.count("word") == ids.count(0) and out.endswith(".")


def test_stream_detokenizer_picks_the_byte_streamer():
    assert not isinstance(ttok.stream_detokenizer(ttok.ByteTokenizer(256)),
                          ttok.StreamingDetokenizer)
    assert isinstance(ttok.stream_detokenizer(_Pieces()),
                      ttok.StreamingDetokenizer)


CORPUS = ["héllo wörld, the quick brown fox 🙂 jumps over ∑ lazy dogs",
          "naïve café déjà vu — résumé", "token streams and byte pieces"] * 20


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE (vocab 300) saved as a local HF tokenizer dir."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    path = tmp_path_factory.mktemp("bpe")
    PreTrainedTokenizerFast(tokenizer_object=tok,
                            eos_token="<|endoftext|>").save_pretrained(path)
    return str(path)


def test_hf_adapter_equals_jax(bpe_dir):
    mine, theirs = ttok.load_hf_tokenizer(bpe_dir), \
        jtok.load_hf_tokenizer(bpe_dir)
    assert mine.vocab_size == theirs.vocab_size == 300
    for text in CORPUS[:3] + ["", "unseen wörds 🙂🙂", "a\nb\tc"]:
        ids = mine.encode(text)
        assert ids == theirs.encode(text)
        assert mine.decode(ids) == theirs.decode(ids) == text
    assert mine.vocab_bytes() == theirs.vocab_bytes()
    assert mine.vocab_bytes(320) == theirs.vocab_bytes(320)
    assert len(mine.vocab_bytes(320)) == 320
    ids = mine.encode("naïve 🙂 café")
    got = _streamed(ttok.stream_detokenizer(mine), ids)
    assert got == _streamed(jtok.stream_detokenizer(theirs), ids)
    assert "".join(got[0]) + got[1] == "naïve 🙂 café"


def test_hf_vocab_bytes_equals_jax_on_both_conventions(bpe_dir):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(bpe_dir, local_files_only=True)
    vb = ttok.hf_vocab_bytes(tok)
    assert vb == jtok.hf_vocab_bytes(tok)
    assert vb[tok.convert_tokens_to_ids("<|endoftext|>")] == b""
    assert {vb[i] for i in tok.encode("é", add_special_tokens=False)} <= \
        {b"\xc3\xa9", b"\xc3", b"\xa9"}

    class _SentencePiece:
        all_special_tokens = ["<s>"]

        @staticmethod
        def get_vocab():
            return {"<s>": 0, "▁the": 1, "<0x0A>": 2, "é": 3, "ab": 4}

    assert ttok.hf_vocab_bytes(_SentencePiece(), 6) == \
        jtok.hf_vocab_bytes(_SentencePiece(), 6) == \
        [b"", b" the", b"\n", "é".encode(), b"ab", b""]


def test_hf_adapter_stays_offline(tmp_path):
    """A directory that does not exist fails at once (a path is never
    taken for a hub name to fetch)."""
    with pytest.raises((OSError, ValueError)):
        ttok.load_hf_tokenizer(str(tmp_path / "no-such-tokenizer"))
