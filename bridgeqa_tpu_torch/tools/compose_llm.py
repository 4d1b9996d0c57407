"""Question -> declaration rewriting with an LLM on the card: the first step
of view selection (``compose_decl_from_qa.py``), with the chat API of
``tools/compose_decl.py::LLMComposer`` replaced by a model the port runs
(``models/deepseek_v2.py``).

- ``LocalLMComposer``: ``LLMComposer.PROMPT`` filled with each question and
  its answer, tokenized, a batch of prompts through
  ``generate_greedy`` (each row stops at EOS or ``max_new_tokens``), the new
  tokens decoded. The tokenizer is any object with ``encode(text) -> ids``
  and ``decode(ids) -> text``; ``WordPieceIds`` adapts the port's
  ``WordPieceTokenizer``.
- ``compose_declarations_batched``: ``compose_declarations``' resumable JSON
  (the same file, written by its ``_flush`` after each batch), composing
  the records not yet done a batch at a time.
"""

import json
import os

import torch

from bridgeqa_tpu_torch.tools.compose_decl import LLMComposer, _flush
from bridgeqa_tpu_torch.utils.profiling import span


class WordPieceIds:
    """``encode``/``decode`` over a ``WordPieceTokenizer``'s ids, without its
    framing tokens or padding."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def encode(self, text: str) -> list:
        tok = self.tokenizer
        return [tok.vocab.get(p, tok.unk_token_id) for p in tok.tokenize(text)]

    def decode(self, ids) -> str:
        return self.tokenizer.decode(ids)


class LocalLMComposer:
    """Declarations from a causal LM with ``generate_greedy`` (the port's
    ``DeepseekV2ForCausalLM``), ``batch_size`` prompts a batch."""

    def __init__(self, model, tokenizer, prompt: str = LLMComposer.PROMPT, batch_size: int = 256,
                 max_new_tokens: int = 24):
        self.model, self.tokenizer, self.prompt = model, tokenizer, prompt
        self.batch_size, self.max_new_tokens = batch_size, max_new_tokens

    def __call__(self, question: str, answer: str | None = None) -> str:
        return self.compose_batch([(question, answer)])[0]

    def compose_batch(self, pairs) -> list:
        """[(question, answer or None)] -> their declarations, in order."""
        cfg = self.model.cfg
        device = self.model.model.embed_tokens.weight.device
        prompts = [[cfg.bos_token_id] + self.tokenizer.encode(self.prompt.format(q=q, a=a or ""))
                   for q, a in pairs]
        out = []
        for s in range(0, len(prompts), self.batch_size):
            chunk = prompts[s:s + self.batch_size]
            lens = [len(p) for p in chunk]
            ids = torch.zeros(len(chunk), max(lens), dtype=torch.long)
            for b, p in enumerate(chunk):
                ids[b, : len(p)] = torch.tensor(p)
            with span("compose"):
                gen = self.model.generate_greedy(ids.to(device), lens,
                                                 [self.max_new_tokens] * len(chunk))
            out += [self.tokenizer.decode(t).strip() for t in gen.tokens]
        return out


def compose_declarations_batched(records, out_path, composer, batch_size: int = 256, *,
                                 resume: bool = True) -> dict:
    """``compose_declarations`` a batch at a time: the records whose
    question id is not in ``out_path`` yet (when resuming) go through
    ``composer.compose_batch`` (or the composer called a record at a time,
    for one without it), and the file is rewritten after each batch.
    Returns {question_id: declaration}."""
    done = {}
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            done = json.load(f)
    pending = [r for r in records if str(r["question_id"]) not in done]
    for s in range(0, len(pending), batch_size):
        chunk = pending[s:s + batch_size]
        pairs = [(r["question"], (r.get("answers") or [None])[0]) for r in chunk]
        outs = (composer.compose_batch(pairs) if hasattr(composer, "compose_batch")
                else [composer(q, a) for q, a in pairs])
        for r, decl in zip(chunk, outs):
            done[str(r["question_id"])] = decl
        _flush(done, out_path)
    _flush(done, out_path)
    return done
