"""Self-contained BERT WordPiece tokenizer + BLIP special-token handling.

The reference uses HuggingFace ``BertTokenizer('bert-base-uncased')`` with
two added tokens (``models/blip.py:319-331``): ``[DEC]`` as bos (id 30522)
and ``[ENC]`` (id 30523), total vocab 30524 (``configs/med_config.json``).
This environment has no network/HF cache, so tokenization is implemented
directly: BERT basic tokenization (lowercase, accent strip, punctuation
split) + greedy longest-match WordPiece against a supplied ``vocab.txt``.
Falls back to HuggingFace when available for byte parity.

All outputs are fixed-shape numpy (question padded to 80 like
``blip_vqa_3d.py:245-247``), ready for the jitted model.

A copy of ``bridgeqa_tpu/data/tokenization.py``, kept in the port because the port imports
nothing of the JAX package; ``tests/test_torch_feed.py`` holds the two equal.
"""

import unicodedata

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
DEC_TOKEN, ENC_TOKEN = "[DEC]", "[ENC]"


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True):
    """BERT BasicTokenizer: clean, lowercase, strip accents, split punct."""
    out = []
    text = " ".join(text.split())
    for token in text.split(" "):
        if lowercase:
            token = token.lower()
            token = unicodedata.normalize("NFD", token)
            token = "".join(c for c in token if unicodedata.category(c) != "Mn")
        current = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
    return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab."""

    def __init__(self, vocab, max_input_chars_per_word: int = 100):
        """vocab: list of tokens (index = id) or dict token->id."""
        if isinstance(vocab, dict):
            self.vocab = dict(vocab)
        else:
            self.vocab = {t: i for i, t in enumerate(vocab)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_input_chars_per_word = max_input_chars_per_word
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        # BLIP special tokens appended after the base vocab (blip.py:326-331)
        for tok in (DEC_TOKEN, ENC_TOKEN):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
                self.inv_vocab[self.vocab[tok]] = tok
        self.pad_token_id = self.vocab[PAD]
        self.unk_token_id = self.vocab[UNK]
        self.cls_token_id = self.vocab[CLS]
        self.sep_token_id = self.vocab[SEP]
        self.bos_token_id = self.vocab[DEC_TOKEN]  # [DEC] is bos (blip.py:330)
        self.enc_token_id = self.vocab[ENC_TOKEN]

    @classmethod
    def from_vocab_file(cls, path):
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return cls(vocab)

    def wordpiece(self, word: str):
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        start, pieces = 0, []
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str):
        return [p for w in basic_tokenize(text) for p in self.wordpiece(w)]

    def encode(self, text: str, max_length: int, *, first_token: int | None = None,
               add_special: bool = True):
        """-> (ids (max_length,), mask (max_length,)) int32, CLS..SEP framed;
        ``first_token`` overwrites position 0 (the [ENC]/[DEC] substitution
        the reference does after tokenization)."""
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if add_special:
            ids = [self.cls_token_id] + ids[: max_length - 2] + [self.sep_token_id]
        else:
            ids = ids[:max_length]
        if first_token is not None:
            ids[0] = first_token
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        out_ids = np.asarray(ids + [self.pad_token_id] * pad, dtype=np.int32)
        out_mask = np.asarray(mask + [0] * pad, dtype=np.int32)
        return out_ids, out_mask

    def encode_batch(self, texts, max_length: int, *, first_token: int | None = None):
        ids, masks = zip(*(self.encode(t, max_length, first_token=first_token) for t in texts))
        return np.stack(ids), np.stack(masks)

    def decode(self, ids, skip_special: bool = True):
        special = {self.pad_token_id, self.cls_token_id, self.sep_token_id,
                   self.bos_token_id, self.enc_token_id}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special and i in special:
                if i == self.sep_token_id and toks:
                    break
                continue
            toks.append(self.inv_vocab.get(i, UNK))
        text = " ".join(toks).replace(" ##", "")
        return text


def build_test_vocab(words, extra_pieces=()):
    """Tiny vocab for tests: specials + whole words + ##pieces."""
    vocab = [PAD, UNK, CLS, SEP, MASK]
    vocab += [w for w in words if w not in vocab]
    vocab += [p for p in extra_pieces if p not in vocab]
    return vocab


def make_question_batch(tokenizer, questions, max_length: int = 80):
    """Reference question prep (``blip_vqa_3d.py:245-247``): tokenize,
    truncate/pad to 80, first token = [ENC]."""
    return tokenizer.encode_batch(questions, max_length, first_token=tokenizer.enc_token_id)


def make_answer_batch(tokenizer, answers, max_length: int):
    """Reference answer prep (``blip_vqa_3d.py:294-296``): first token = [DEC]."""
    return tokenizer.encode_batch(answers, max_length, first_token=tokenizer.bos_token_id)


def make_answer_list(tokenizer, all_answers, max_length: int):
    """Static answer-list table for rank inference."""
    return make_answer_batch(tokenizer, all_answers, max_length)
