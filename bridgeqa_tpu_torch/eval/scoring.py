"""Answer scoring: EM@1/EM@10 + captioning metrics, dependency-free.

Equivalent of ``scripts/score.py`` + the VQA-style answer normalization in
``lib/qa_helper.py:101-186``. The reference shells out to pycocoevalcap
(Java METEOR, PTB tokenizer); this module implements the metrics directly
in python so scoring runs anywhere:

- BLEU-1..4: corpus-level, closest-reference length brevity penalty
  (the COCO/pycocoevalcap convention);
- ROUGE-L: LCS F-measure with beta=1.2, max over references, mean over
  samples (COCO convention);
- CIDEr: pycocoevalcap CIDEr-D semantics bit-for-bit — raw tf x idf
  vectors, min-clipped numerator, per-n cosine, length gaussian penalty
  (sigma=6), df from the gt corpus;
- METEOR: Lavie-Agarwal aligner (exact + Porter-stem stages, minimal-chunk
  tiebreak; nltk-oracle-matched) with harmonic mean alpha=0.9 and
  fragmentation penalty gamma=0.5 beta=3 — the Java METEOR 1.5 WordNet
  synonym stage is inactive (no corpus offline), flagged in the output key.

A copy of ``bridgeqa_tpu/eval/scoring.py``, kept in the port because the port imports
nothing of the JAX package; ``tests/test_torch_eval.py`` holds the two equal.
"""

import collections
import math
import re

# --- VQA answer normalization (qa_helper.py:101-186 semantics) ---

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "im": "i'm", "ive": "i've", "isnt": "isn't", "itd": "it'd", "itll": "it'll",
    "lets": "let's", "maam": "ma'am", "mightve": "might've", "mustve": "must've",
    "shant": "shan't", "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "somebodyd": "somebody'd", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed": "we'd", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all",
    "youd": "you'd", "youll": "you'll", "youre": "you're", "youve": "you've",
}
_DIGIT_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
              "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
          ">", "<", "@", "`", ",", "?", "!"]
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


def process_punctuation(text):
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (_COMMA_STRIP.search(text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text):
    out = []
    for word in text.lower().split():
        word = _DIGIT_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def prep_ans(answer):
    """``qa_helper.prep_ans``: punctuation + digit/article + comma strip."""
    answer = process_digit_article(process_punctuation(answer))
    return answer.replace(",", "")


# --- EM metrics ---

def exact_match(preds_top10, golds):
    """preds_top10: {qid: [ans,...] (ranked)}; golds: {qid: [gold answers]}.
    Returns (EM@1, EM@10)."""
    em1 = em10 = n = 0
    for qid, top in preds_top10.items():
        gold = set(golds[qid])
        n += 1
        if top and top[0] in gold:
            em1 += 1
        if any(t in gold for t in top[:10]):
            em10 += 1
    return em1 / max(n, 1), em10 / max(n, 1)


def top1_f_value(gts, res):
    """The reference's 'Top1 (F-value)' (score.py:43-49 + 65-74): for EM
    misses, the max over references of a unigram-overlap F1 on lemmatized
    tokens (``simple_ratio`` both ways, harmonic mean); EM hits score 1.
    Degraded mode: identity lemmatization (the reference uses nltk's
    WordNetLemmatizer; no corpus offline) — plural/inflection variants
    score slightly lower than the reference would."""
    def lemma(s):
        return s.split()

    def ratio(numerator, denominator):
        return (sum(1 for t in denominator if t in numerator)
                / max(len(denominator), 1))

    scores = []
    for qid in res:
        pred = res[qid][0]
        if pred in set(gts[qid]):
            scores.append(1.0)
            continue
        best = 0.0
        for ref_s in gts[qid]:
            p = ratio(lemma(ref_s), lemma(pred))
            r = ratio(lemma(pred), lemma(ref_s))
            best = max(best, 2 * r * p / (r + p) if (r + p) else 0.0)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# --- n-gram helpers ---

def _ngrams(tokens, n):
    return collections.Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# pycocoevalcap PTBTokenizer's dropped-punctuation list (ptbtokenizer.py)
_PTB_PUNCT = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
              ".", "?", "!", ",", ":", "-", "--", "...", ";"}
_CLITICS = re.compile(r"\b(\w+)(n't|'s|'re|'ve|'ll|'d|'m)\b")
_EDGES = re.compile(r"""^([.,!?:;'"`-]*)(.*?)([.,!?:;'"`-]*)$""")


def _tok(s):
    """PTB-approximate tokenization (the reference runs gts/res through
    pycocoevalcap's Java PTBTokenizer before every caption metric,
    score.py:104-109): lowercase, split clitics ("it's" -> "it 's"),
    separate punctuation at TOKEN EDGES only and drop the PTB punctuation
    tokens. Intra-token punctuation stays intact ("3.5", "l-shaped",
    "3:30" are single tokens), matching the Stanford tokenizer's handling
    of decimals/hyphenated words; still an approximation of its full
    behavior on arbitrary prose."""
    out = []
    for t in _CLITICS.sub(r"\1 \2", s.lower()).split():
        if t in ("n't", "'s", "'re", "'ve", "'ll", "'d", "'m"):
            out.append(t)  # clitic tokens keep their apostrophe (PTB form)
            continue
        m = _EDGES.match(t)
        for part in m.groups():
            if part and part not in _PTB_PUNCT:
                out.append(part)
    return out


# --- BLEU (corpus-level, COCO convention) ---

def bleu(gts, res, max_n: int = 4):
    """gts: {qid: [ref strings]}, res: {qid: [hypothesis string]}.
    Returns list of BLEU-1..max_n."""
    tot_match = [0] * max_n
    tot_count = [0] * max_n
    hyp_len = ref_len = 0
    for qid in res:
        hyp = _tok(res[qid][0])
        refs = [_tok(r) for r in gts[qid]]
        hyp_len += len(hyp)
        # closest reference length
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref = collections.Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            tot_match[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_ng.items())
            tot_count[n - 1] += max(sum(hyp_ng.values()), 0)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p = tot_match[n] / tot_count[n] if tot_count[n] else 0.0
        # COCO uses a tiny epsilon instead of zeroing out higher orders
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


# --- ROUGE-L ---

def _lcs(a, b):
    dp = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            dp[i][j] = dp[i - 1][j - 1] + 1 if a[i - 1] == b[j - 1] else max(dp[i - 1][j], dp[i][j - 1])
    return dp[-1][-1]


def rouge_l(gts, res, beta: float = 1.2):
    """ROUGE-L exactly as the reference's scorer computes it (pycocoevalcap
    ``rouge.py``): the max PRECISION and max RECALL are taken SEPARATELY
    over the references (possibly from different refs) before the
    F-combination — not the max of per-reference F-scores."""
    scores = []
    for qid in res:
        hyp = _tok(res[qid][0])
        prec_max = rec_max = 0.0
        for ref_s in gts[qid]:
            ref = _tok(ref_s)
            lcs = _lcs(hyp, ref)
            prec_max = max(prec_max, lcs / len(hyp) if hyp else 0.0)
            rec_max = max(rec_max, lcs / len(ref) if ref else 0.0)
        if prec_max and rec_max:
            score = ((1 + beta**2) * prec_max * rec_max) / (rec_max + beta**2 * prec_max)
        else:
            score = 0.0
        scores.append(score)
    return sum(scores) / max(len(scores), 1)


# --- CIDEr ---

def cider(gts, res, max_n: int = 4, sigma: float = 6.0):
    """CIDEr-D exactly as the reference's scorer computes it (pycocoevalcap
    ``cider_scorer.py``): RAW term-frequency x idf vectors (no tf
    normalization), a MIN-CLIPPED numerator ``min(h, r) * r`` (penalizes
    hypothesis n-gram repetition beyond the reference count), per-n cosine
    normalization, gaussian length penalty (sigma=6), mean over n, x10."""
    # document frequency over the gt corpus (each n-gram once per question)
    df = collections.Counter()
    for qid in gts:
        seen = set()
        for ref_s in gts[qid]:
            for n in range(1, max_n + 1):
                seen |= set(_ngrams(_tok(ref_s), n).keys())
        for ng in seen:
            df[ng] += 1
    log_num_docs = math.log(max(len(gts), 1))

    def counts2vec(tokens):
        vecs, norms = [], []
        for n in range(1, max_n + 1):
            vec = {}
            s = 0.0
            for ng, c in _ngrams(tokens, n).items():
                idf = log_num_docs - math.log(max(df.get(ng, 0), 1.0))
                vec[ng] = c * idf
                s += vec[ng] * vec[ng]
            vecs.append(vec)
            norms.append(math.sqrt(s))
        return vecs, norms

    def sim(hv, hn, rv, rn, len_h, len_r):
        penalty = math.exp(-((len_h - len_r) ** 2) / (2 * sigma**2))
        total = 0.0
        for n in range(max_n):
            num = sum(min(hv[n][ng], rv[n].get(ng, 0.0)) * rv[n].get(ng, 0.0)
                      for ng in hv[n])
            s = num / (hn[n] * rn[n]) if hn[n] and rn[n] else 0.0
            total += s * penalty
        return total

    scores = []
    for qid in res:
        hyp = _tok(res[qid][0])
        hv, hn = counts2vec(hyp)
        s = 0.0
        for ref_s in gts[qid]:
            ref = _tok(ref_s)
            rv, rn = counts2vec(ref)
            s += sim(hv, hn, rv, rn, len(hyp), len(ref))
        # pycocoevalcap: mean over n, then / num refs, then x10
        scores.append(10.0 * s / max_n / max(len(gts[qid]), 1))
    return sum(scores) / max(len(scores), 1)


# --- approximate METEOR ---

def _porter_stem():
    try:
        from nltk.stem.porter import PorterStemmer

        return PorterStemmer().stem
    except ImportError:  # pragma: no cover - nltk is baked into the image
        return lambda w: w


def _meteor_match_stage(hyp_enum, ref_enum):
    """One alignment stage: greedy surface-form matching, scanning the
    hypothesis RIGHT-to-left and consuming each surface form's LAST unmatched
    reference position first (METEOR reference implementation order; see
    Lavie & Agarwal 2007). Returns (matches, leftover_hyp, leftover_ref) with
    enumerated (original_index, word) pairs."""
    ref_positions = {}
    for j, (_, ref_word) in enumerate(ref_enum):
        ref_positions.setdefault(ref_word, []).append(j)
    matches = []
    matched_h, matched_r = set(), set()
    for i in range(len(hyp_enum) - 1, -1, -1):
        positions = ref_positions.get(hyp_enum[i][1])
        if positions:
            j = positions.pop()
            matched_h.add(i)
            matched_r.add(j)
            matches.append((hyp_enum[i][0], ref_enum[j][0]))
    left_h = [p for i, p in enumerate(hyp_enum) if i not in matched_h]
    left_r = [p for j, p in enumerate(ref_enum) if j not in matched_r]
    return matches, left_h, left_r


def single_meteor(reference, hypothesis, stem, alpha=0.9, beta=3.0, gamma=0.5):
    """METEOR (Lavie & Agarwal 2007) for one tokenized (reference,
    hypothesis) pair: exact-match stage, then Porter-stem stage (the WordNet
    synonym stage is inactive — no corpus data offline; exact+stem is the
    classic 'meteor-stem' configuration)."""
    hyp_enum = list(enumerate(w.lower() for w in hypothesis))
    ref_enum = list(enumerate(w.lower() for w in reference))
    if not hyp_enum or not ref_enum:
        return 0.0
    exact, left_h, left_r = _meteor_match_stage(hyp_enum, ref_enum)
    stems_h = [(i, stem(w)) for i, w in left_h]
    stems_r = [(j, stem(w)) for j, w in left_r]
    stemmed, _, _ = _meteor_match_stage(stems_h, stems_r)
    matches = sorted(exact + stemmed)
    m = len(matches)
    if m == 0:
        return 0.0
    precision = m / len(hyp_enum)
    recall = m / len(ref_enum)
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    chunks = 1
    for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
        if i2 != i1 + 1 or j2 != j1 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return (1 - penalty) * fmean


def meteor(gts, res, alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5):
    """Corpus METEOR: per sample the best score over the references
    (``scripts/score.py`` via pycocoevalcap; this is the full Lavie-Agarwal
    aligner with exact + Porter-stem stages), averaged over samples."""
    stem = _porter_stem()
    scores = []
    for qid in res:
        hyp = _tok(res[qid][0])
        best = max((single_meteor(_tok(r), hyp, stem, alpha, beta, gamma)
                    for r in gts[qid]), default=0.0)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# backwards-compatible alias (pre-round-2 name)
meteor_approx = meteor


# --- question-type breakdown (score.py:128-148) ---

QT = ["Place", "Number", "Color", "Object nature", "Object", "Other"]


def qclass1(question: str) -> str:
    if "Where" in question:
        return "Place"
    if "How many" in question:
        return "Number"
    if "What color" in question or "What is the color" in question:
        return "Color"
    if "What shape" in question or "What type" in question or "What kind" in question:
        return "Object nature"
    if "What is" in question:
        return "Object"
    return "Other"


def score_predictions(preds, gold_records):
    """Full scoring surface of ``scripts/score.py``.

    preds: {qid: {'answer_top10': [...], 'question': str}}
    gold_records: list of {'question_id', 'answers', 'question'}.
    Returns dict of metrics (percentages like the reference prints).
    """
    golds = {str(r["question_id"]): r["answers"] for r in gold_records}
    top10 = {qid: p["answer_top10"] for qid, p in preds.items() if qid in golds}
    em1, em10 = exact_match(top10, golds)

    gts = {qid: golds[qid] for qid in top10}
    res = {qid: [top10[qid][0]] for qid in top10}
    bleus = bleu(gts, res)
    out = {
        "EM@1": em1 * 100,
        "EM@10": em10 * 100,
        "Top1 (F-value)": top1_f_value(gts, res) * 100,
        "BLEU-1": bleus[0] * 100,
        "BLEU-2": bleus[1] * 100,
        "BLEU-3": bleus[2] * 100,
        "BLEU-4": bleus[3] * 100,
        "ROUGE-L": rouge_l(gts, res) * 100,
        "METEOR": meteor(gts, res) * 100,
        "CIDEr": cider(gts, res) * 100,
    }
    # per question-type EM@1
    by_type = collections.defaultdict(list)
    gold_by_qid = {str(r["question_id"]): r for r in gold_records}
    for qid in top10:
        q = gold_by_qid[qid].get("question", "")
        hit = 1.0 if top10[qid] and top10[qid][0] in set(golds[qid]) else 0.0
        by_type[qclass1(q)].append(hit)
    for t in QT:
        if by_type[t]:
            out[f"EM@1 {t}"] = 100 * sum(by_type[t]) / len(by_type[t])
    return out
