"""Answer vocabulary + frequency scoring.

Equivalents of the ``Answer`` vocab (``lib/dataset.py:88-109``), the
frequency-weighted soft score (``get_answer_score``, ``dataset.py:54-64``)
and the train+val answer-candidate builder (``scripts/train.py:189-201``).

A copy of ``bridgeqa_tpu/data/answers.py``, kept in the port because the port imports
nothing of the JAX package; ``tests/test_torch_feed.py`` holds the two equal.
"""

import collections


class Answer:
    """answer <-> index with ignore_idx for OOV (``dataset.py:88-109``)."""

    def __init__(self, answers=None, unk_token=None, ignore_idx=-100):
        if answers is None:
            answers = []
        self.unk_token = unk_token
        self.ignore_idx = ignore_idx
        self.vocab = list(answers)
        self.rev = {a: i for i, a in enumerate(self.vocab)}

    def itos(self, i):
        if i == self.ignore_idx:
            return self.unk_token
        return self.vocab[i]

    def stoi(self, a):
        return self.rev.get(a, self.ignore_idx)

    def __len__(self):
        return len(self.vocab)


def get_answer_score(freq: int) -> float:
    """Soft supervision weight by answer frequency (``dataset.py:54-64``)."""
    if freq == 0:
        return 0.0
    if freq == 1:
        return 0.3
    if freq == 2:
        return 0.6
    if freq == 3:
        return 0.9
    return 1.0


def build_answer_vocab(train_records, val_records, answer_max_size: int = -1, answer_min_freq: int = 1):
    """``get_answer_cands`` (``train.py:189-201``): train+val answers, most
    common first, min-frequency filter, (-freq, lexicographic) sort.

    Returns (answer_cands list, answer_counter dict).
    """
    answer_counter = sum([d["answers"] for d in train_records], [])
    answer_counter += sum([d["answers"] for d in val_records], [])
    answer_counter = collections.Counter(sorted(answer_counter))
    if answer_max_size < 0:
        answer_max_size = len(answer_counter)
    answer_counter = dict(
        [x for x in answer_counter.most_common()[:answer_max_size] if x[1] >= answer_min_freq]
    )
    answer_cands = sorted(answer_counter.keys(), key=lambda x: (-answer_counter[x], x))
    return answer_cands, answer_counter
