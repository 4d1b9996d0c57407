"""Question -> declarative-sentence rewriting for view selection.

Equivalent of ``compose_decl_from_qa.py:48-133``: each question+answer pair
is rewritten into a caption-like declarative sentence ("What color is the
chair?" + "brown" -> "the brown chair"), which matches BLIP-ITM's
image-caption pretraining distribution far better than a question does.

The reference calls an external LLM API (threaded, resumable JSON, retried
up to 100x). This module keeps that driver shape but makes the composer
pluggable:

- ``LLMComposer``: OpenAI-compatible chat API, used when a key/endpoint is
  configured (zero-egress environments skip it);
- ``RuleBasedComposer``: deterministic template rewrite covering the ScanQA
  question families (what/where/how many/...) — a dependency-free fallback
  that needs no network.

A copy of ``bridgeqa_tpu/tools/compose_decl.py`` (it imports no JAX), kept in
the port because the port imports nothing of the JAX package;
``tests/test_torch_tools.py`` holds the two equal.
"""

import json
import os
import re
import time


class RuleBasedComposer:
    """Deterministic Q+A -> declaration templates."""

    _PATTERNS = [
        # (regex on the lowercase question, template with {m} groups + {a})
        (re.compile(r"^what (?:is the )?colou?r (?:is|are|of) (?:the )?(.*?)\??$"), "the {a} {0}"),
        (re.compile(r"^what (?:type|kind|shape) of (.*?) (?:is|are).*?\??$"), "the {a} {0}"),
        (re.compile(r"^how many (.*?) (?:are|is).*?\??$"), "{a} {0}"),
        (re.compile(r"^where (?:is|are) (?:the )?(.*?)\??$"), "the {0} {a}"),
        (re.compile(r"^what (?:is|are) (?:on|in|under|next to|near|behind|above|below) (?:the )?(.*?)\??$"),
         "the {a} is {0}"),
        (re.compile(r"^what (?:is|are) (?:the )?(.*?)\??$"), "the {0} is {a}"),
        (re.compile(r"^which (.*?) (?:is|are) (.*?)\??$"), "the {0} {1} is {a}"),
    ]

    def __call__(self, question: str, answer: str | None = None) -> str:
        q = question.strip().lower()
        a = (answer or "").strip().lower()
        for pat, template in self._PATTERNS:
            m = pat.match(q)
            if m:
                out = template
                for i, g in enumerate(m.groups()):
                    out = out.replace("{" + str(i) + "}", g or "")
                out = out.replace("{a}", a)
                return " ".join(out.split()).strip()
        # fallback: strip the wh-word, append the answer
        words = [w for w in q.rstrip("?").split() if w not in
                 ("what", "where", "which", "how", "is", "are", "does", "do")]
        return " ".join(words + ([a] if a else [])).strip()


class LLMComposer:
    """OpenAI-compatible chat rewrite (``compose_decl_from_qa.py:48-90``),
    retried with sleep like the reference (up to ``max_retries``)."""

    PROMPT = ("Rewrite the question and its answer as one short declarative "
              "sentence describing the scene. Question: {q} Answer: {a}")

    def __init__(self, model: str = "gpt-3.5-turbo", max_retries: int = 100, retry_sleep: float = 1.0):
        self.model = model
        self.max_retries = max_retries
        self.retry_sleep = retry_sleep

    def available(self) -> bool:
        return bool(os.environ.get("OPENAI_API_KEY"))

    def __call__(self, question: str, answer: str | None = None) -> str:
        import openai  # gated: only when the API is configured

        client = openai.OpenAI()
        last_err = None
        for _ in range(self.max_retries):
            try:
                resp = client.chat.completions.create(
                    model=self.model,
                    messages=[{"role": "user",
                               "content": self.PROMPT.format(q=question, a=answer or "")}],
                )
                return resp.choices[0].message.content.strip()
            except Exception as e:  # noqa: BLE001 — reference retries everything
                last_err = e
                time.sleep(self.retry_sleep)
        raise RuntimeError(f"LLM rewrite failed after {self.max_retries} retries") from last_err


def compose_declarations(records, out_path, *, composer=None, resume: bool = True):
    """Rewrite every record's question; resumable JSON like the reference
    (partial results flushed; rerun picks up where it left off).

    Returns {question_id: declaration}.
    """
    composer = composer or RuleBasedComposer()
    done = {}
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            done = json.load(f)

    for i, rec in enumerate(records):
        qid = str(rec["question_id"])
        if qid in done:
            continue
        answers = rec.get("answers") or [None]
        done[qid] = composer(rec["question"], answers[0])
        if (i + 1) % 100 == 0:
            _flush(done, out_path)
    _flush(done, out_path)
    return done


def _flush(done, out_path):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(done, f)
