"""Operations and bytes of the cells' matrix products, counted from their
shapes.

A product of an (m, k) matrix with a (k, n) one counts ``2 m k n``
operations; an attention over ``q`` queries and ``kv`` keys of width ``h``
(all heads) counts ``2 q kv h`` for the scores and as many for the context.
Bytes count each input read once and each output written once.

The rank forward's count follows ``bench.py``'s arithmetic
(``scoring_pass_flops_bytes``, ``vit_flops``), rewritten for the port's
routing and extended to every product of the forward: the detector's shared
MLPs and heads, the ViT, the twin encoder, both decoders' first-token and
scoring passes, the vocabulary products, the fusion and the grounding head.
``qa_bench/tests/test_flops.py`` holds it to a count by hand at tiny shapes
and to ``bench.py``'s formulas at the full ones.
"""

F32_BYTES = 4


def dense(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def attention(q_rows: int, kv: int, width: int) -> int:
    """Scores and context of ``q_rows`` queries over ``kv`` keys each."""
    return 2 * 2 * q_rows * kv * width


def mlp(rows: int, widths) -> int:
    """A stack of products over ``rows``: widths [in, w1, w2, ...]."""
    return sum(dense(rows, a, b) for a, b in zip(widths[:-1], widths[1:]))


def gemm_call(m: int, k: int, n: int, elem: int, residual: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one ``scoring_gemm`` call: x (m, k), w (n, k)
    and the output (m, n) in the working type, an f32 bias, and a residual
    (m, n) where the epilogue adds one."""
    nbytes = (m * k + n * k + m * n * (2 if residual else 1)) * elem + n * F32_BYTES
    return dense(m, k, n), nbytes


def vit_gemm_calls(images: int, tokens: int, dim: int, mlp_dim: int, depth: int,
                   elem: int) -> list:
    """The fused ViT's ``scoring_gemm`` calls: per block QKV, attention
    output, MLP in, and MLP out with the block's residual."""
    rows = images * tokens
    block = [gemm_call(rows, dim, 3 * dim, elem), gemm_call(rows, dim, dim, elem),
             gemm_call(rows, dim, mlp_dim, elem), gemm_call(rows, mlp_dim, dim, elem, True)]
    return block * depth


def vit_flops(images: int, image_size: int, dim: int, mlp_dim: int, depth: int,
              patch: int = 16) -> int:
    """Every product of a ViT over ``images``: the patch embedding, each
    block's four products and its attention, and nothing after the final
    LayerNorm."""
    patches = (image_size // patch) ** 2
    tokens = patches + 1
    rows = images * tokens
    block = (dense(rows, dim, 3 * dim) + dense(rows, dim, dim) + dense(rows, dim, mlp_dim)
             + dense(rows, mlp_dim, dim) + attention(rows, tokens, dim))
    return dense(images * patches, 3 * patch * patch, dim) + depth * block


def bert_layer(rows: int, seq: int, hidden: int, ffn: int, cross_kv: int = 0,
               cross_rows: int = 0) -> int:
    """One post-LN layer over ``rows`` tokens of ``seq``-token sequences:
    self-attention, and with ``cross_kv`` keys a cross-attention whose keys
    and values are projected from ``cross_rows`` encoder rows; then the
    FFN."""
    f = dense(rows, hidden, 3 * hidden) + attention(rows, seq, hidden) + dense(rows, hidden, hidden)
    if cross_kv:
        f += (dense(rows, hidden, hidden) + dense(cross_rows, hidden, 2 * hidden)
              + attention(rows, cross_kv, hidden) + dense(rows, hidden, hidden))
    return f + dense(rows, hidden, ffn) + dense(rows, ffn, hidden)


def scoring_gemm_calls(c: dict, batch: int, k_test: int, answer_len: int, elem: int) -> list:
    """The fused scoring layers' ``scoring_gemm`` calls, both decoders: per
    layer QKV, attention output, cross query, cross output, FFN in and FFN
    out over the ``batch * k_test * answer_len`` answer tokens."""
    med = c["blip"]["med"]
    h, ff = med["hidden_size"], med["intermediate_size"]
    rows = batch * k_test * answer_len
    layer = [gemm_call(rows, h, 3 * h, elem), gemm_call(rows, h, h, elem),
             gemm_call(rows, h, h, elem), gemm_call(rows, h, h, elem),
             gemm_call(rows, h, ff, elem), gemm_call(rows, ff, h, elem)]
    return layer * med["num_hidden_layers"] * 2


def vocab_calls(c: dict, batch: int, k_test: int, answer_len: int, elem: int) -> list:
    """One vocabulary pass a decoder: the transformed states of every answer
    token but the last against the tied word table. Bytes: the states and
    the table in the working type, the f32 bias, the int32 labels and the
    three f32 per-row reductions."""
    med = c["blip"]["med"]
    h, v = med["hidden_size"], med["vocab_size"]
    rows = batch * k_test * (answer_len - 1)
    nbytes = (rows * h + v * h) * elem + v * F32_BYTES + rows * 4 + 3 * rows * F32_BYTES
    return [(dense(rows, h, v), nbytes)] * 2


def detector_flops(c: dict, batch: int) -> int:
    """The detector's shared MLPs and heads (the grouping, FPS and the
    interpolation are not products)."""
    w, d = c["pointnet_width"], c["pointnet_depth"]
    np1, np2, np3, np4 = c["backbone_sa_npoints"]
    ns1, ns2, ns3, ns4 = c["backbone_sa_nsamples"]
    seed, p, nprop = c["seed_feat_dim"], c["proposal_size"], c["num_proposal"]
    f = mlp(batch * np1 * ns1, [3 + c["input_feature_dim"]] + [64 * w] * d + [128 * w])
    f += mlp(batch * np2 * ns2, [3 + 128 * w] + [128 * w] * d + [256 * w])
    f += mlp(batch * np3 * ns3, [3 + 256 * w] + [128 * w] * d + [256 * w])
    f += mlp(batch * np4 * ns4, [3 + 256 * w] + [128 * w] * d + [256 * w])
    f += mlp(batch * np3, [512 * w, 256 * w, 256 * w])
    f += mlp(batch * np2, [512 * w, 256 * w, seed])
    f += mlp(batch * np2, [seed, seed, seed, 3 + seed])  # votes
    f += mlp(batch * nprop * 16, [3 + seed, p, p, p])  # vote aggregation
    out_dim = (2 + 3 + c["num_heading_bin"] * 2 + c["num_size_cluster"] * 4
               + c["num_object_class"])
    return f + mlp(batch * nprop, [p, p, p, out_dim])


def rank_flops(c: dict, batch: int, k_test: int, question_len: int, answer_len: int) -> int:
    """Every matrix product of one rank forward."""
    blip, med = c["blip"], c["blip"]["med"]
    h, ff, layers, vocab = (med["hidden_size"], med["intermediate_size"],
                            med["num_hidden_layers"], med["vocab_size"])
    hq, nprop = c["hidden_size"], c["num_proposal"]
    tokens = (blip["image_size"] // 16) ** 2 + 1
    q_rows = batch * question_len
    k = min(k_test, c["num_answers"])
    f = detector_flops(c, batch) + dense(batch * nprop, c["proposal_size"], hq)
    dim, mlp_dim, depth, _ = vit_dims(blip)
    f += vit_flops(batch, blip["image_size"], dim, mlp_dim, depth)
    f += mlp(batch * nprop, [hq, h, h])  # scene adapter
    # twin encoder: the 2D stream attends to [image | question], the 3D one
    # to [scene | question]
    for keys in (tokens + question_len, nprop + question_len):
        f += layers * bert_layer(q_rows, question_len, h, ff, keys, batch * keys)
    rows, rows_next = batch * k * answer_len, batch * k * (answer_len - 1)
    for _ in range(2):  # the 2D and the 3D decoder
        f += layers * bert_layer(batch, 1, h, ff, question_len, q_rows)  # first token
        f += dense(batch, h, h) + dense(batch, h, vocab)
        f += layers * bert_layer(rows, answer_len, h, ff, question_len, q_rows)  # scoring
        f += dense(rows, h, h) + dense(rows_next, h, vocab)
    low = h // 8
    f += 2 * dense(q_rows, h, low) + 2 * q_rows * low * low * h  # low-rank bilinear fusion
    f += mlp(batch, [h, hq, c["num_object_class"]])  # language head
    f += dense(q_rows, h, hq)  # fused states to the grounding width
    for _ in range(c["mcan_num_layers"]):  # SGA: proposals attend to themselves, then the question
        prop = batch * nprop
        f += 4 * dense(prop, hq, hq) + attention(prop, nprop, hq)
        f += 2 * dense(prop, hq, hq) + 2 * dense(q_rows, hq, hq) + attention(prop, question_len, hq)
        f += mlp(prop, [hq, 4 * hq, hq])
    return f + mlp(batch * nprop, [hq, hq, 1])


def vit_dims(c: dict) -> tuple[int, int, int, int]:
    """(width, MLP width, depth, heads) of the ViT a configuration names."""
    if c.get("vit", "base") == "base":
        return 768, 3072, 12, 12
    dim = c["vit_custom_embed_dim"]
    return dim, 4 * dim, c["vit_custom_depth"], c["vit_custom_heads"]


def itm_image_flops(c: dict, images: int) -> int:
    """``encode_images``: the ViT and the projection of each CLS state."""
    dim, mlp_dim, depth, _ = vit_dims(c)
    return vit_flops(images, c["image_size"], dim, mlp_dim, depth) + dense(images, dim,
                                                                         c["embed_dim"])


def itm_text_flops(c: dict, texts: int, text_len: int) -> int:
    """``encode_texts``: the text tower without cross-attention and the
    projection of each CLS state."""
    med = c["med"]
    h, ff = med["hidden_size"], med["intermediate_size"]
    tower = med["num_hidden_layers"] * bert_layer(texts * text_len, text_len, h, ff)
    return tower + dense(texts, h, c["embed_dim"])
