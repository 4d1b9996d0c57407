"""Beam-search generation for the answer decoders (counterpart of
``bridgeqa_tpu/models/generation.py``, same names and semantics).

The reference's open-ended answer path (HF ``generate``): ``num_beams * 2``
beams per question, half cross-attending to the 2D question states and half
to the 3D ones, all in one beam pool; eos = [SEP], no length penalty.
Finished beams are frozen: they emit ``pad`` at log-prob 0, so their score
stops changing. The loop is a host loop over ``max_length - 1`` steps, all
of them, as JAX's ``fori_loop`` runs them: an early exit would have to ask
the card whether every beam has finished, a host sync per step.

Order of ties follows JAX: the top k of each question's candidates through
``top_k_stable`` (``lax.top_k``'s lower-index-first order), the final sort
with a stable argsort (``jnp.argsort`` is stable).
"""

import torch

NEG_INF = -1.0e9


def top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` does not promise one)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def interleave_streams(h2d, h3d, num_beams: int):
    """Per sample, the beam pool's encoder rows are ``[h2d x num_beams, h3d
    x num_beams]`` (the reference's ``concat_repeat``).

    h2d/h3d: (B, Lq, H) -> (B * 2 * num_beams, Lq, H)."""
    b = h2d.shape[0]
    rep = torch.stack([h2d, h3d], dim=1).repeat_interleave(num_beams, dim=1)
    return rep.reshape(b * 2 * num_beams, *h2d.shape[1:])


def _initial_beams(batch_size: int, k: int, max_length: int, bos_token_id: int,
                   pad_token_id: int, device):
    # the scalars go in by fill_: an item assigned a Python number is a
    # copy from the host, which waits for the card
    ids = torch.full((batch_size, k, max_length), pad_token_id, dtype=torch.int32, device=device)
    ids[:, :, 0].fill_(bos_token_id)
    # only beam 0 is alive at the start (the beams are identical otherwise)
    scores = torch.full((batch_size, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0].fill_(0.0)
    finished = torch.zeros((batch_size, k), dtype=torch.bool, device=device)
    return ids, scores, finished


def _extend_beams(t: int, ids, scores, finished, logits, *, eos_token_id: int,
                  pad_token_id: int, min_length: int):
    """One step of the search: the next-token log-probs of every beam
    (``logits`` (B*K, V), the f32 log-softmax of the logits as the decoder
    returns them), the min-length eos ban, the frozen finished beams, the
    top K of each question's K*V candidates. Returns (ids, scores,
    finished, beam_idx (B, K): the beam each new beam extends)."""
    batch_size, k, _ = ids.shape
    v = logits.shape[-1]
    next_logp = torch.log_softmax(logits.float(), dim=-1).reshape(batch_size, k, v)
    if t + 1 < min_length:
        # HF's MinLengthLogitsProcessor: at step t the sequence has t + 1
        # tokens, the bos included
        next_logp[..., eos_token_id].fill_(NEG_INF)
    frozen = torch.full((v,), NEG_INF, dtype=torch.float32, device=logits.device)
    frozen[pad_token_id].fill_(0.0)
    next_logp = torch.where(finished[..., None], frozen, next_logp)

    cand = (scores[..., None] + next_logp).reshape(batch_size, k * v)
    top_idx = top_k_stable(cand, k)
    top_scores = cand.gather(1, top_idx)
    beam_idx = top_idx // v
    token_idx = (top_idx % v).to(ids.dtype)

    new_ids = ids.gather(1, beam_idx[..., None].expand_as(ids))
    new_ids[:, :, t + 1] = token_idx
    new_finished = finished.gather(1, beam_idx) | (token_idx == eos_token_id)
    return new_ids, top_scores, new_finished, beam_idx


def _best_first(ids, scores):
    order = torch.argsort(-scores, dim=1, stable=True)
    return ids.gather(1, order[..., None].expand_as(ids)), scores.gather(1, order)


def beam_search(decode_fn, batch_size: int, num_beams: int, *, bos_token_id: int,
                eos_token_id: int, pad_token_id: int, max_length: int = 20,
                min_length: int = 1, device: torch.device | str = "cuda"):
    """Beam search that runs the whole prefix through the decoder at every
    step (no cache).

    decode_fn(flat_ids (B*K, L), flat_mask (B*K, L)) -> logits (B*K, L, V);
    the function closes over per-beam-row encoder states (so different
    beams of one sample may attend to different streams). The beams are
    made on ``device``.

    Returns (sequences (B, K, max_length), scores (B, K)) sorted best-first.
    """
    k = num_beams
    ids, scores, finished = _initial_beams(batch_size, k, max_length, bos_token_id,
                                           pad_token_id, device)
    positions = torch.arange(max_length, device=device)
    for t in range(max_length - 1):
        flat_ids = ids.reshape(batch_size * k, max_length)
        flat_mask = (positions <= t).to(torch.int32)[None].expand_as(flat_ids)
        logits = decode_fn(flat_ids, flat_mask)
        ids, scores, finished, _ = _extend_beams(
            t, ids, scores, finished, logits[:, t], eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, min_length=min_length)
    return _best_first(ids, scores)


def _leaves(cache) -> list:
    if isinstance(cache, dict):
        return [x for val in cache.values() for x in _leaves(val)]
    if isinstance(cache, list):
        return [x for val in cache for x in _leaves(val)]
    return [cache] if isinstance(cache, torch.Tensor) else []


def reorder_cache(cache, rows):
    """Every tensor of ``cache`` (nested dicts and lists) whose first dim
    has one entry per beam row, gathered along it by ``rows`` (B*K,);
    everything else (``pos``) as it is. A hypothesis carries its whole state
    with it: its self-attention prefix and its cross K/V and bias."""
    if isinstance(cache, dict):
        return {key: reorder_cache(val, rows) for key, val in cache.items()}
    if isinstance(cache, list):
        return [reorder_cache(val, rows) for val in cache]
    if isinstance(cache, torch.Tensor) and cache.dim() > 0 and cache.shape[0] == rows.shape[0]:
        return cache.index_select(0, rows)
    return cache


def beam_search_cached(decode_step_fn, cache, batch_size: int, num_beams: int, *,
                       bos_token_id: int, eos_token_id: int, pad_token_id: int,
                       max_length: int = 20, min_length: int = 1):
    """KV-cached beam search (the reference's ``past_key_value`` and
    ``_reorder_cache``): one token through the decoder a step.

    decode_step_fn(token_ids (B*K, 1), cache) -> (logits (B*K, V), new
    cache). After every step the whole cache is reordered with its beams
    (``reorder_cache``): a beam born on a 3D row stays 3D wherever it lands.
    (``beam_search`` instead reads a moved prefix under its destination
    row's stream; the two agree wherever all rows of a sample share one
    stream.) The beams are made on the cache's device.

    Returns (sequences (B, K, max_length), scores (B, K)) sorted best-first.
    """
    k = num_beams
    device = _leaves(cache)[0].device
    ids, scores, finished = _initial_beams(batch_size, k, max_length, bos_token_id,
                                           pad_token_id, device)
    first_row = torch.arange(batch_size, device=device)[:, None] * k
    for t in range(max_length - 1):
        tok = ids[:, :, t].reshape(batch_size * k, 1)
        logits, cache = decode_step_fn(tok, cache)
        ids, scores, finished, beam_idx = _extend_beams(
            t, ids, scores, finished, logits, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, min_length=min_length)
        cache = reorder_cache(cache, (first_row + beam_idx).reshape(-1))
    return _best_first(ids, scores)


def generate_answers(decoder_apply, question_states, question_mask, batch_size: int,
                     num_beams: int, *, bos_token_id: int, eos_token_id: int,
                     pad_token_id: int, max_length: int = 20, min_length: int = 1):
    """The interleaved-stream beam search without a cache; returns the best
    sequence per question. question_states: (B * K, Lq, H) per-beam encoder
    rows (K = 2 * num_beams when interleaving 2D/3D); question_mask: (B, Lq).

    decoder_apply(ids, mask, enc_states, enc_mask) -> logits.
    Returns (best_ids (B, max_length), best_scores (B,)).
    """
    k = question_states.shape[0] // batch_size
    q_mask = question_mask.repeat_interleave(k, dim=0)

    def decode_fn(flat_ids, flat_mask):
        return decoder_apply(flat_ids, flat_mask, question_states, q_mask)

    ids, scores = beam_search(
        decode_fn, batch_size, k, bos_token_id=bos_token_id, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id, max_length=max_length, min_length=min_length,
        device=question_states.device)
    return ids[:, 0], scores[:, 0]
