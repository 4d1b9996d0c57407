"""The port's offline tools against the JAX package's, on the CPU: BLIP-ITM
(``models/blip_itm.py``), view selection (``tools/view_select.py``), the
declaration composer (``tools/compose_decl.py``, a copy), the
back-projection (``tools/projection.py`` and the label and colour votes of
``scripts/project_multiview_labels.py``), and every ported tool driver run
end to end at its smallest flags.

Same weights (JAX's ``init`` carried across by ``convert.load_jax_variables``,
biases and LayerNorm parameters moved away from 0 and (1, 0) so a dropped one
shows), same numpy inputs, f32 on both sides.

Tolerances: BLIP-ITM's features, cosines and matching logits within 1e-5
(f32, sums in another order); the rankings equal. The projection's uv and
valid equal, except where JAX's value before ``round`` lies within 1e-4 of a
half-integer (the two sides divide and add in f32 in their own order, so
such a point may round either way): those points are counted, at most 0.1%
of them, and left out of every comparison downstream; the features,
votes and colours there exact (a gather, a max, an argmax of counts) and the
means within 1e-6.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgeqa_tpu.models import blip_itm as jblip_itm
from bridgeqa_tpu.models import med as jmed
from bridgeqa_tpu.ops import vit_block as jvb
from bridgeqa_tpu.tools import compose_decl as jcompose_decl
from bridgeqa_tpu.tools import projection as jprojection
from bridgeqa_tpu.tools import view_select as jview_select
from bridgeqa_tpu_torch.convert import export_jax_variables, load_jax_variables
from bridgeqa_tpu_torch.data import views
from bridgeqa_tpu_torch.data.sources import synthetic_records, synthetic_tokenizer
from bridgeqa_tpu_torch.models import blip_itm, med
from bridgeqa_tpu_torch.models.layers import init_weights
from bridgeqa_tpu_torch.ops import vit_block as vb
from bridgeqa_tpu_torch.tools import compose_decl, projection, view_select
from scripts import project_multiview_labels as jlabels
from tests.test_torch_bridgeqa import _port_cfg
from tests.test_torch_feed import assert_same_code
from tests.test_torch_vit import _perturbed

ITM_TOL = 1e-5
# a fused-capable tiny ViT (embed 128, 2 heads of 64, depth 2, 48 px: 10
# tokens, which JAX pads to 16) and a 2-layer text tower of width 64
JMED = jmed.MedConfig(vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, max_position_embeddings=64, encoder_width=128)
JCFG = jblip_itm.BlipITMConfig(med=JMED, image_size=48, vit="custom", embed_dim=32,
                               vit_custom_embed_dim=128, vit_custom_depth=2, vit_custom_heads=2)
TEXT_LEN = 12


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def itm_pair():
    rng = np.random.RandomState(0)
    jmodel = jblip_itm.BLIPITM(JCFG)
    ids = np.ones((2, 8), np.int32)
    img = np.zeros((2, 48, 48, 3), np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), img, ids, ids, method=jmodel.init_all)
    variables = _perturbed(variables, rng)
    cfg = _port_cfg(blip_itm.BlipITMConfig, JCFG, med=_port_cfg(med.MedConfig, JMED))
    model = load_jax_variables(blip_itm.BLIPITM(cfg, device="cpu"), variables)
    return jmodel, variables, model


def _itm_inputs(seed=1):
    rng = np.random.RandomState(seed)
    images = rng.rand(3, 48, 48, 3).astype(np.float32)
    ids = rng.randint(1, 200, (3, TEXT_LEN)).astype(np.int32)
    mask = np.ones((3, TEXT_LEN), np.int32)
    mask[1, 7:] = 0  # a padded text
    return images, ids, mask


@pytest.mark.parametrize("mode", ["force", "off"])
def test_blip_itm_matches_jax(itm_pair, monkeypatch, mode):
    """``encode_images``, ``encode_texts``, ``itc_scores`` and ``itm_scores``
    with the fused ViT forced on both sides (JAX in interpret mode) and with
    the module loop."""
    jmodel, variables, model = itm_pair
    images, ids, mask = _itm_inputs()
    monkeypatch.setattr(jvb, "FUSED_MODE", mode)
    monkeypatch.setattr(vb, "FUSED_MODE", mode)
    calls = []
    fused = vb.fused_vit_blocks
    monkeypatch.setattr(vb, "fused_vit_blocks", lambda *a, **k: calls.append(1) or fused(*a, **k))
    want = {
        "encode_images": jmodel.apply(variables, images, method=jmodel.encode_images),
        "encode_texts": jmodel.apply(variables, ids, mask, method=jmodel.encode_texts),
        "itc_scores": jmodel.apply(variables, images, ids, mask),
        "itm_scores": jmodel.apply(variables, images, ids, mask, match_head="itm"),
    }
    with torch.no_grad():
        got = {
            "encode_images": model.encode_images(_t(images)),
            "encode_texts": model.encode_texts(_t(ids), _t(mask)),
            "itc_scores": model(_t(images), _t(ids), _t(mask)),
            "itm_scores": model(_t(images), _t(ids), _t(mask), match_head="itm"),
        }
    # the ViT ran fused in encode_images, itc_scores and itm_scores
    assert len(calls) == (3 if mode == "force" else 0)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == np.shape(w) and np.isfinite(g).all(), key
        np.testing.assert_allclose(g, np.asarray(w), atol=ITM_TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(np.linalg.norm(got["encode_images"].numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_blip_itm_round_trip(itm_pair):
    """``export_jax_variables`` gives back the JAX tree, leaf for leaf and
    in the flax layouts, and loads into a fresh model unchanged."""
    _, variables, model = itm_pair
    exported = export_jax_variables(model)
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(exported["params"]))
    assert set(map(jax.tree_util.keystr, got)) == set(map(jax.tree_util.keystr, want))
    by_key = {jax.tree_util.keystr(k): v for k, v in got.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(by_key[jax.tree_util.keystr(k)], np.asarray(v))
    fresh = load_jax_variables(blip_itm.BLIPITM(model.cfg, device="cpu"), exported)
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), name


# ------------------------------------------------------- view selection

def _frames(scene_id):
    """Seven frames a scene: a padded second batch of 4."""
    rng = np.random.RandomState(sum(map(ord, scene_id)))
    return [f"{i * 20}.jpg" for i in range(7)], rng.rand(7, 48, 48, 3).astype(np.float32)


def test_view_selection_matches_jax(itm_pair, tmp_path):
    """``select_best_views`` on 2 scenes x 7 frames, the same frame loader
    and tokenizer on both sides: the rankings equal, the scores within
    1e-5; the i2tfile round-trips as .json and as pickle into the data
    pipeline's loader."""
    jmodel, variables, model = itm_pair
    records = synthetic_records(6, num_scenes=2)
    tokenizer = synthetic_tokenizer()
    decl = jcompose_decl.compose_declarations(records, str(tmp_path / "decl.json"))
    kw = dict(decl_map=decl, image_batch=4, text_batch=2, text_len=TEXT_LEN)
    want = jview_select.select_best_views(jmodel, variables, records, tokenizer, _frames, **kw)
    got = view_select.select_best_views(model, records, tokenizer, _frames, **kw)
    assert got["view"] == want["view"]
    assert len(got["view"]) == 6 and all(len(v) == 7 for v in got["view"].values())
    for qid, scores in want["itm_scores"].items():
        np.testing.assert_allclose(got["itm_scores"][qid], scores, atol=ITM_TOL, rtol=0)
    for name in ("i2t.json", "i2t.pkl"):
        path = str(tmp_path / name)
        view_select.save_i2tfile(got, path)
        assert views.load_scene_view_map(path) == got["view"], name
    with open(path, "rb") as f:
        assert pickle.load(f) == got
    # and through the lookup the feed builds from it: each question's best
    # frame, then its next two
    for topk in (1, 3):
        lookup = views.make_view_lookup(_FramePool(), views.load_scene_view_map(path), topk)
        for rec in records:
            qid = str(rec["question_id"])
            images, _, poses = lookup(rec["scene_id"], qid)
            assert images.tolist() == [int(n[:-4]) for n in got["view"][qid][:topk]]
            assert poses.shape == (topk, 16)


class _FramePool:
    """A ``SceneViewsPool`` whose frame "image" is its number."""

    def get(self, scene_id, name):
        return np.float32(name[:-4]), np.zeros((2, 2), np.float32), np.eye(4, dtype=np.float32)


def test_pad_batch_matches_jax():
    arr = np.arange(14, dtype=np.float32).reshape(7, 2)
    for batch in (1, 3, 4, 7):
        got, n = view_select._pad_batch(arr, batch)
        want, wn = jview_select._pad_batch(arr, batch)
        np.testing.assert_array_equal(got, want)
        assert n == wn == 7


# ------------------------------------------------------------- composer

def test_compose_decl_is_the_original():
    """The copy is the original, definition for definition, and composes
    the same strings on synthetic records and the template families."""
    assert_same_code(compose_decl, jcompose_decl)
    records = synthetic_records(12) + [
        {"question_id": "x1", "question": "Where is the table?", "answers": ["by the wall"]},
        {"question_id": "x2", "question": "Does the weird contraption spin?", "answers": []},
        {"question_id": "x3", "question": "Which chair is brown?", "answers": ["left"]},
    ]
    got, want = compose_decl.RuleBasedComposer(), jcompose_decl.RuleBasedComposer()
    for rec in records:
        a = (rec.get("answers") or [None])[0]
        assert got(rec["question"], a) == want(rec["question"], a)


# ----------------------------------------------------------- projection

W, H = projection.FEATURE_DIMS
V, N = 4, 3000


def _scene(seed=0):
    """Points in front of V random cameras, ScanNet's intrinsics at the
    feature grid, depth maps near the points' depths."""
    rng = np.random.RandomState(seed)
    intr = projection.adjust_intrinsic(
        np.array([[577.870605, 0, 319.5, 0], [0, 577.870605, 239.5, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]]), (640, 480), (W, H))
    poses = []
    for _ in range(V):
        a = rng.randn(3, 3)
        q, _ = np.linalg.qr(a)
        q *= np.sign(np.linalg.det(q))
        pose = np.eye(4)
        pose[:3, :3] = q if rng.rand() < 0.5 else np.eye(3) + 0.1 * (q - np.eye(3))
        pose[:3, 3] = rng.randn(3) * 0.3
        poses.append(pose)
    poses = np.stack(poses).astype(np.float32)
    cam = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.2, 1.2, N),
                    rng.uniform(0.05, 4.5, N), np.ones(N)], 1)
    points = (cam @ poses[0].astype(np.float64).T)[:, :3].astype(np.float32)
    depths = rng.uniform(0.5, 4.0, (V, H, W)).astype(np.float32)
    # every 3rd pixel of view 0 at the depth of a point that lands there
    z = cam[:, 2]
    u = np.round(intr[0, 0] * cam[:, 0] / z + intr[0, 2]).astype(int)
    v = np.round(intr[1, 1] * cam[:, 1] / z + intr[1, 2]).astype(int)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    for k in np.nonzero(inside)[0][::3]:
        depths[0, v[k], u[k]] = z[k]
    return intr, points, poses, depths, rng


def _ties(intr, points, poses):
    """(V, N) True where JAX's value before round lies within 1e-4 of a
    half-integer, in u or in v."""
    intr = jnp.asarray(np.asarray(intr, np.float32))
    out = []
    for pose in poses:
        w2c = jnp.linalg.inv(jnp.asarray(pose))
        pts = jnp.concatenate([jnp.asarray(points), jnp.ones((len(points), 1))], 1)
        pcam = (pts @ w2c.T)[:, :3]
        z = pcam[:, 2]
        safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        pre = [intr[0, 0] * pcam[:, 0] / safe_z + intr[0, 2],
               intr[1, 1] * pcam[:, 1] / safe_z + intr[1, 2]]
        near = [np.abs(np.asarray(p) - np.floor(np.asarray(p)) - 0.5) < 1e-4 for p in pre]
        out.append(near[0] | near[1])
    return np.stack(out)


@pytest.fixture(scope="module")
def projected():
    intr, points, poses, depths, rng = _scene()
    helper = projection.ProjectionHelper(intr)
    jhelper = jprojection.ProjectionHelper(intr)
    ties = _ties(intr, points, poses)
    keep = ~ties.any(axis=0)  # points no view rounds on a tie
    print(f"projection: {int(ties.sum())} of {ties.size} (view, point) pairs on a half-integer "
          f"tie, {int((~keep).sum())} points left out")
    assert ties.sum() <= 1e-3 * ties.size
    return intr, points, poses, depths, rng, helper, jhelper, keep


def test_project_matches_jax(projected):
    _, points, poses, depths, _, helper, jhelper, keep = projected
    uv, valid = helper.project(_t(points), _t(poses), _t(depths))
    assert uv.dtype == torch.int32 and uv.shape == (V, N, 2) and valid.shape == (V, N)
    for k in range(V):
        juv, jvalid = jhelper.project(jnp.asarray(points), jnp.asarray(poses[k]),
                                      jnp.asarray(depths[k]))
        np.testing.assert_array_equal(uv[k].numpy()[keep], np.asarray(juv)[keep])
        np.testing.assert_array_equal(valid[k].numpy()[keep], np.asarray(jvalid)[keep])
    # the data reach every gate: hits, and misses of each kind
    assert 100 < int(valid.sum()) < valid.numel() // 2


def test_project_features_and_aggregation_match_jax(projected):
    _, points, poses, depths, rng, helper, jhelper, keep = projected
    feats = rng.randn(V, H, W, 16).astype(np.float32)
    got, got_valid = helper.project_features(_t(points), _t(poses), _t(depths), _t(feats))
    for k in range(V):
        want, _ = jhelper.project_features(jnp.asarray(points), jnp.asarray(poses[k]),
                                           jnp.asarray(depths[k]), jnp.asarray(feats[k]))
        np.testing.assert_array_equal(got[k].numpy()[keep], np.asarray(want)[keep])
    for mode in ("maxpool", "mean"):
        agg = projection.aggregate_multiview(got, got_valid, mode)
        jagg = jprojection.aggregate_multiview(got.numpy(), got_valid.numpy(), mode)
        np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), atol=1e-6, rtol=0,
                                   err_msg=mode)
        scene = projection.project_scene_multiview(helper, _t(points), _t(poses), _t(depths),
                                                   _t(feats), mode)
        jscene = jprojection.project_scene_multiview(jhelper, points, poses, depths, feats, mode)
        np.testing.assert_allclose(scene.numpy()[keep], np.asarray(jscene)[keep], atol=1e-6,
                                   rtol=0, err_msg=mode)
    with pytest.raises(ValueError):
        projection.aggregate_multiview(got, got_valid, "median")


def test_project_labels_and_color_match_jax(projected):
    from bridgeqa_tpu_torch.scripts import project_multiview_labels as labels

    _, points, poses, depths, rng, helper, jhelper, keep = projected
    num_classes = 5  # few classes: votes tie, and argmax takes the first
    maps = rng.randint(0, num_classes, (V, H, W)).astype(np.int32)
    maps[:, ::4, ::3] = -1  # outside [0, num_classes): no vote
    maps[:, 1::5, ::2] = num_classes
    got = labels.project_labels(helper, _t(points), _t(poses), _t(depths), _t(maps), num_classes)
    want = np.asarray(jlabels.project_labels(jhelper, points, poses, depths, maps, num_classes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    assert (want == -1).any() and (want >= 0).any()
    colors = rng.rand(V, H, W, 3).astype(np.float32)
    got = labels.project_color(helper, _t(points), _t(poses), _t(depths), _t(colors))
    want = np.asarray(jlabels.project_color(jhelper, points, poses, depths, colors))
    np.testing.assert_allclose(got.numpy()[keep], want[keep], atol=1e-6, rtol=0)


def test_adjust_intrinsic_is_the_original():
    assert_same_code(projection, jprojection, names=("adjust_intrinsic", "DEPTH_MIN",
                                                     "DEPTH_MAX", "ACCURACY", "FEATURE_DIMS"))


# -------------------------------------------------------------- drivers

def _tree(root):
    """{relative path: (shape, dtype)} of every .npy under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npy"):
                a = np.load(os.path.join(d, f))
                out[os.path.relpath(os.path.join(d, f), root)] = (a.shape, a.dtype)
    return out


@pytest.fixture
def one_thread():
    """PyTorch on one thread for the test: the suite runs several workers
    on the machine's cores, and the drivers' many small ops on a full set of
    threads each wait far longer for the cores than they compute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tool_drivers_write_what_the_jax_drivers_write(tmp_path, monkeypatch, one_thread):
    """Each ported driver at its smallest flags on the CPU, in this process:
    the files the JAX driver writes, under the same names, shapes and
    dtypes (the projections' JAX drivers run beside them); the view
    ranking's questions, frame names and declarations, the JAX driver's
    (its records, its six frames a scene, its composer); the multiview
    features' layout with a padded last batch; the parity report's fields,
    no skipped parameter and corners of (32, 8, 3); the profilers'
    phases."""
    import scripts.project_multiview_color as jcolor_script
    import scripts.project_multiview_features as jfeatures_script
    from bridgeqa_tpu_torch.scripts import (compute_multiview_features, profile_loader,
                                            profile_train, project_multiview_color,
                                            project_multiview_features,
                                            project_multiview_labels, verify_parity)
    from bridgeqa_tpu_torch.scripts import view_select as view_script

    monkeypatch.setattr(jvb, "FUSED_MODE", "off")
    # the projections: the JAX drivers run too
    for port, jax_main, extra in (
            (project_multiview_features, jfeatures_script.main, []),
            (project_multiview_labels, jlabels.main, ["--what", "labels"]),
            (project_multiview_color, jcolor_script.main, [])):
        ours, theirs = tmp_path / f"{port.__name__}.port", tmp_path / f"{port.__name__}.jax"
        assert port.main(["--synthetic", "--device", "cpu", "--out", str(ours)] + extra) == 1
        jax_main(["--synthetic", "--out", str(theirs)] + extra)
        assert _tree(ours) == _tree(theirs) and _tree(ours), port.__name__

    # view selection: the JAX driver's questions (synthetic_records(8)), each
    # ranking its scene's six frames, and its composer's declarations
    i2t = view_script.main(["--synthetic", "--tiny", "--device", "cpu",
                            "--out", str(tmp_path / "i2t.json")])
    records = synthetic_records(8)
    assert set(i2t) == {"view", "itm_scores"}
    assert set(i2t["view"]) == {r["question_id"] for r in records}
    for qid, names in i2t["view"].items():
        assert sorted(names, key=lambda n: int(n[:-4])) == [f"{i * 20}.jpg" for i in range(6)]
        assert len(i2t["itm_scores"][qid]) == 6
    assert views.load_scene_view_map(str(tmp_path / "i2t.json")) == i2t["view"]
    with open(tmp_path / "i2t.json.decl.json") as f:
        want = jcompose_decl.compose_declarations(records, str(tmp_path / "jdecl.json"))
        assert json.load(f) == want

    # ENet features: the JAX driver's layout, <out>/<scene>/<frame>.npy in
    # (32, 41, 128) f32, 2 scenes of 4 frames; batches of 3, the last padded
    out = tmp_path / "mv"
    assert compute_multiview_features.main(["--synthetic", "--device", "cpu", "--batch", "3",
                                            "--out", str(out)]) == 8
    want_tree = {f"synth{s:04d}_00/{f * 20}.npy": ((32, 41, 128), np.dtype(np.float32))
                 for s in range(2) for f in range(4)}
    assert _tree(out) == want_tree
    # the padded batch's real frame, as the encoder computes it alone
    *_, (scene, frame, image) = compute_multiview_features.iter_frames(
        compute_multiview_features.parse_args(["--synthetic", "--out", str(out)]))
    encoder = compute_multiview_features.build_encoder(
        compute_multiview_features.parse_args(["--synthetic", "--out", str(out)]),
        torch.device("cpu"))
    with torch.no_grad():
        alone = encoder(torch.from_numpy(image[None]))[0].numpy()
    np.testing.assert_allclose(np.load(out / scene / f"{frame}.npy"), alone, atol=1e-5, rtol=0)

    # parity: a detector checkpoint at the reference's names
    ckpt = tmp_path / "det.pth"
    torch.save({"model": {k: _t(v) for k, v in _detector_state_dict().items()}}, ckpt)
    report = verify_parity.main(["--checkpoint", str(ckpt), "--synthetic", "--tiny_backbone",
                                 "--num_points", "2048", "--num_proposal", "32", "--device",
                                 "cpu", "--out", str(tmp_path / "report.json")])
    assert report["stage"] == "DET" and report["params_skipped"] == []
    assert report["params_loaded"] == len(_detector_state_dict())
    assert np.asarray(report["bbox_corners"]).shape == (32, 8, 3)
    assert len(report["objectness"]) == 32 and 0 <= report["num_boxes_kept"] <= 32
    with open(tmp_path / "report.json") as f:
        assert json.load(f) == report

    from bridgeqa_tpu_torch.ops import grouping
    assert grouping.FORCE_MODE is None  # set back after the forward

    sps = profile_loader.main(["--device", "cpu", "--batch", "2", "--num_workers", "1",
                               "--num_points", "2048", "--image_size", "64",
                               "--min_samples", "4"])
    assert sps > 0
    results = profile_train.main(["--smoke", "--device", "cpu"])
    assert set(results) == set(profile_train.PHASES)
    assert all(t > 0 for t in results.values())


def test_view_select_loads_an_itm_checkpoint(tmp_path):
    """``--itm_ckpt``: a BLIP-ITM state dict at the reference's names (its
    position embeddings on a 4x4 grid, the tiny model's 2x2) goes through
    the port's copies of the converters into the model: every array loads,
    each equal to the JAX package's conversion of the same file."""
    from bridgeqa_tpu.utils import blip_checkpoint as jblip_checkpoint
    from bridgeqa_tpu_torch.scripts import view_select as view_script
    from tests.test_torch_converters import _RefStateDict

    args = view_script.parse_args(["--synthetic", "--tiny", "--out", "unused"])
    tree = export_jax_variables(view_script.build_model(args, torch.device("cpu")))["params"]
    ref = _RefStateDict(np.random.RandomState(5))
    vit, width = tree["visual_encoder"], tree["visual_encoder"]["cls_token"].shape[-1]
    ref.sd["visual_encoder.cls_token"] = ref._draw((1, 1, width), 0.5)
    ref.sd["visual_encoder.pos_embed"] = ref._draw((1, 1 + 16, width), 0.5)
    ref.sd["visual_encoder.patch_embed.proj.weight"] = ref._draw(
        vit["patch_embed_proj"]["kernel"].transpose(3, 2, 0, 1).shape)
    ref.sd["visual_encoder.patch_embed.proj.bias"] = ref._draw((width,))
    ref.norm("visual_encoder.norm", vit["norm"])
    for i in range(2):
        blk, key = vit[f"blocks_{i}"], f"visual_encoder.blocks.{i}"
        for norm in ("norm1", "norm2"):
            ref.norm(f"{key}.{norm}", blk[norm])
        for name, node in (("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                           ("mlp.fc1", blk["mlp"]["fc1"]), ("mlp.fc2", blk["mlp"]["fc2"])):
            ref.linear(f"{key}.{name}", node)
    ref.embeddings("text_encoder.embeddings", tree["text_encoder"]["embeddings"])
    ref.encoder("text_encoder.encoder", tree["text_encoder"]["encoder"])
    for head in ("vision_proj", "text_proj", "itm_head"):
        ref.linear(head, tree[head])
    path = tmp_path / "itm.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ref.sd.items()}}, path)

    args = view_script.parse_args(["--synthetic", "--tiny", "--itm_ckpt", str(path),
                                   "--out", "unused"])
    got = export_jax_variables(view_script.build_model(args, torch.device("cpu")))["params"]
    sd = jblip_checkpoint.load_torch_checkpoint(str(path))
    want = {"visual_encoder": jblip_checkpoint.convert_vit(sd, "visual_encoder", 4),
            "text_encoder": {
                "embeddings": jblip_checkpoint._bert_embeddings(sd, "text_encoder.embeddings",
                                                                200),
                "encoder": jblip_checkpoint.convert_bert_encoder(sd, "text_encoder.encoder",
                                                                 twin=False)},
            **{h: jblip_checkpoint._linear(sd, h) for h in ("vision_proj", "text_proj",
                                                            "itm_head")}}
    want_leaves, got_leaves = _leaves_by_key(want), _leaves_by_key(got)
    assert set(want_leaves) == set(got_leaves)  # every parameter came from the file
    for k, v in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[k], v, err_msg=k)


def _leaves_by_key(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _detector_state_dict() -> dict:
    """A DET-stage reference checkpoint (``verify_parity``'s tiny backbone,
    32 proposals) at the reference's names, as
    ``tests/test_torch_converters.py`` builds one."""
    from bridgeqa_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from bridgeqa_tpu_torch.models.bridgeqa import BridgeQA, BridgeQAConfig
    from tests.test_torch_converters import _RefStateDict

    cfg = BridgeQAConfig(num_answers=1, num_proposal=32, stage="DET",
                         backbone_sa_npoints=(128, 64, 32, 16), backbone_sa_nsamples=(8, 8, 8, 8))
    model = BridgeQA(cfg, ScannetDatasetConfig().mean_size_arr, device="cpu")
    tree = export_jax_variables(init_weights(model, torch.Generator().manual_seed(0)))
    ref = _RefStateDict(np.random.RandomState(3))
    ref.detector(tree["params"]["detector"], tree["batch_stats"]["detector"])
    return ref.sd


@pytest.mark.parametrize("name,argv", [
    ("view_select", ["--synthetic", "--tiny", "--out", "i2t.json"]),
    ("compute_multiview_features", ["--synthetic", "--out", "mv"]),
    ("project_multiview_features", ["--synthetic", "--out", "proj"]),
    ("project_multiview_labels", ["--synthetic", "--out", "lbl"]),
    ("project_multiview_color", ["--synthetic", "--out", "col"]),
    ("verify_parity", ["--checkpoint", "missing.pth", "--synthetic"]),
    ("profile_loader", []),
    ("profile_train", ["--smoke"]),
])
def test_drivers_refuse_a_missing_card(name, argv, tmp_path, monkeypatch):
    """Every tool driver runs on the card unless asked for the CPU: without
    one it raises before it reads or writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs a machine without one")
    monkeypatch.chdir(tmp_path)
    driver = importlib.import_module(f"bridgeqa_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        driver.main(argv)
    assert list(tmp_path.iterdir()) == []


def test_port_imports_nothing_of_jax_anywhere():
    """No module of the port, the tools and drivers included, imports JAX or
    the JAX package (a fresh interpreter imports every one)."""
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys, bridgeqa_tpu_torch\n"
            "for m in pkgutil.walk_packages(bridgeqa_tpu_torch.__path__, 'bridgeqa_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'bridgeqa_tpu' or m.startswith('bridgeqa_tpu.')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
