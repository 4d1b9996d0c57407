"""The numbers ``correct`` compares: what the timed path produced against
what the reference produced from the same inputs and weights.

Each function returns plain floats; ``within`` holds them to the cell's
limits (``limits`` in its traffic file), which PERF.md derives from the
program's readings over a dozen seeds and the control's.
"""

import torch

UNSCORED = -1e4


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def abs_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double().to(got.device)).abs().max())


def ranked(scores: dict, weight: float) -> torch.Tensor:
    """The ensemble a rank forward ranks by, in log space:
    log(exp(s_2d) + exp(w s_3d)) (random weights put every sum near -100,
    where the ensemble itself underflows to 0 in f32)."""
    return torch.logaddexp(scores["answer_scores_2d"].double(),
                           weight * scores["answer_scores_scene"].double())


def rank_numbers(got: dict, want: dict, weight: float) -> dict:
    """A rank forward's outputs against the reference's:

    - ``detector_gap``: the relative gap of the detector outputs the twin
      encoder and the grounding read (aggregated features, objectness,
      centres, class scores, box corners);
    - ``score_gap``: each decoder's largest gap of a scored log-probability
      sum, over the answers both sides scored (nats);
    - ``topk_miss``: the share of each decoder's top-k answers that only
      one side scored (the first-token probabilities picked another);
    - ``top1_miss``: rows whose ensemble top-1 differs and whose reference
      margin between the two picks exceeds twice the row's largest
      difference of a ranked score;
    - ``ground_gap``: the relative gap of the grounding scores (cluster_ref)
      and the language head's."""
    det = max(rel_gap(got[k], want[k]) for k in
              ("aggregated_vote_features", "objectness_scores", "center", "sem_cls_scores",
               "bbox_corner"))
    score_gap, miss = 0.0, 0.0
    for key in ("answer_scores_2d", "answer_scores_scene"):
        g, r = got[key].double(), want[key].double().to(got[key].device)
        gs, rs = g != UNSCORED, r != UNSCORED
        both = gs & rs
        if both.any():
            score_gap = max(score_gap, float((g - r).abs()[both].max()))
        miss = max(miss, float((gs ^ rs).sum()) / max(1, float(rs.sum())) / 2.0)
    g_ens, r_ens = ranked(got, weight), ranked(want, weight).to(got["answer_scores_2d"].device)
    scored = ((got["answer_scores_2d"] != UNSCORED) | (got["answer_scores_scene"] != UNSCORED)) & \
             ((want["answer_scores_2d"].to(g_ens.device) != UNSCORED)
              | (want["answer_scores_scene"].to(g_ens.device) != UNSCORED))
    row_diff = torch.where(scored, (g_ens - r_ens).abs(), 0.0).amax(dim=1)
    g1, r1 = g_ens.argmax(dim=1), r_ens.argmax(dim=1)
    margin = r_ens.gather(1, r1[:, None])[:, 0] - r_ens.gather(1, g1[:, None])[:, 0]
    top1 = int(((g1 != r1) & (margin > 2.0 * row_diff)).sum())
    ground = max(rel_gap(got["cluster_ref"], want["cluster_ref"]),
                 rel_gap(got["lang_scores"], want["lang_scores"]))
    return {"detector_gap": det, "score_gap": score_gap, "topk_miss": miss,
            "top1_miss": float(top1), "ground_gap": ground}


def view_numbers(img: torch.Tensor, img_ref: torch.Tensor, txt: torch.Tensor,
                 txt_ref: torch.Tensor, sims, order) -> dict:
    """A scene's view selection against the reference's:

    - ``image_gap``, ``text_gap``: the largest absolute gap of a normalised
      feature's element;
    - ``sim_gap``: the largest gap of a similarity;
    - ``order_miss``: ranked positions where the program's frame differs
      from the reference's and the reference's similarities of the two
      frames differ by more than twice the row's largest similarity gap.
    ``sims`` and ``order`` are the tool's (questions, frames) arrays."""
    sims_ref = (txt_ref.double() @ img_ref.double().T).cpu()
    sims = torch.as_tensor(sims).double()
    order = torch.as_tensor(order).long()
    row_gap = (sims - sims_ref).abs().amax(dim=1, keepdim=True)
    order_ref = torch.argsort(-sims_ref, dim=1, stable=True)
    differs = order != order_ref
    apart = (sims_ref.gather(1, order) - sims_ref.gather(1, order_ref)).abs() > 2.0 * row_gap
    return {"image_gap": abs_gap(img, img_ref), "text_gap": abs_gap(txt, txt_ref),
            "sim_gap": float((sims - sims_ref).abs().max()),
            "order_miss": float((differs & apart).sum())}


def within(numbers: dict, limits: dict) -> list:
    """One check per number that has a limit: ok while the number is at
    most its limit. A number without one (its control reads no higher than
    the program, PERF.md) is only logged."""
    return [{"name": k, "value": numbers[k], "limit": limit, "ok": numbers[k] <= limit}
            for k, limit in limits.items()]
