"""Plain float32 reference of Graph-DETR4D's multi-point graph variant
(detr4d_res50_deform_pe_mp_testaug_2subset_12e): the flagship's
ResNet-50 with DCNv2, FPN and Detr3DHeadPE (reference/flagship.py), with
each decoder layer's cross-attention the multi-point graph attention of
projects/mmdet3d_plugin/models/utils/deform3d_cross_attn_multi_point.py
:34-453:

  * a query graph over the reference points entering the layer: each
    query's 8 nearest other queries by Euclidean distance in [0, 1]^3;
  * the centre branch: learned 3D offsets around the query's own point,
    4 points a head and level, softmax over levels x points, times the
    in-view mask, gated by sigmoid camera weights;
  * the neighbour branch (:369-433): the 8 neighbours' points with no
    offset, max(P // 4, 1) points a head and level, softmax over levels
    x points of the query's own logits, times the in-view mask, weighted
    by the RAW (unsigmoided) camera weights of the query (:424-429),
    summed over cameras and neighbours;
  * the fusion (:436-439): softmax over the 2 outputs of `output_weight`
    (2C -> 2) summed over the queries, the two branches mixed by it;
  * output projection, residual and the positional MLP of the centre
    point, as the flagship's.

Quirks of the published module kept: no query_pos anywhere in the layer
(the line adding it is commented out, :220-221), the raw neighbour gate,
and both gates reading the (B, Q, N) memory of the camera weights as
(B, N, Q) (for the neighbours the (B, K Q, N) rows) by a reinterpretation,
not a transpose (:227-228, :424-425).

Departures from the published code, each noted where the program makes
the same choice (graph_detr4d_tpu_torch/models/attention_variants.py,
models/transformer.py):

  * the neighbour rows are neighbour-major (row j Q + q is query q's
    j-th neighbour) for the points, the gate and the attention logits
    alike; the published module takes its neighbour logits query-major
    (:373-375) and its points and gates neighbour-major (:421-424);
  * the fusion weights are each sample's own, not sample 0's for the
    whole batch (:439): the same at batch 1, the benchmark's batch;
  * the graph: the published decoder that builds it is absent from the
    reference repository (its configs name a Detr3DTransformerDecoderMP
    that no file defines), so it is the Graph-DETR3D paper's query graph,
    as the program builds it;
  * everything is float32 with TF32 off; the program computes in
    bfloat16 with float32 reference points, graph, softmax, gate,
    projections into the cameras and decode.

Nothing the program computes enters here: the graph of each layer is
built from this reference's own reference points. The program's
bfloat16 points can order two near-equal distances the other way, so
its graph and this one may differ in rows whose 8th and 9th nearest
neighbours are nearly tied.
"""

import torch

from . import flagship
from .common import coords_3d, inverse_sigmoid, lid_bins, sine_pe_3d
from .flagship import _linear, _ln, _xavier, msda, offset_bias

features = flagship.features


# ------------------------------------------------------------ parameters
# The fusion's logits are sums over the Q queries of `output_weight`'s
# products with rows of norm 150-500 (the neighbour branch's raw gate
# sums 12 cameras x 8 neighbours; the reference at full head width on
# 128x320 images, 2 seeds): at lecun scale they reach 10^3, the softmax
# reads 0 / 1 and one branch drops out of each layer. At this scale they
# are of order 1, so both branches reach every layer's output.
FUSE_STD = 1e-5


def cross_specs(specs, p, h):
    """Deform3DCrossAttnMP's tensors, in the program's order."""
    C, nh, L, P, N = (h["embed_dims"], h["num_heads"], h["num_levels"],
                      h["num_points"], h["num_cams"])
    pn = max(P // 4, 1)
    _linear(specs, p + "cam_attention_weights", N, C)
    _linear(specs, p + "deform_sampling_offsets", nh * P * 3, C,
            bias_init=("values", offset_bias(nh, P)))
    _linear(specs, p + "value_proj", C, C, init=_xavier(C, C))
    _linear(specs, p + "attention_weights", nh * L * P, C)
    _linear(specs, p + "attention_weights_neighbor", nh * L * pn, C)
    _linear(specs, p + "output_weight", 2, 2 * C, init=("normal", FUSE_STD))
    _linear(specs, p + "output_proj", C, C, init=_xavier(C, C))
    _linear(specs, p + "position_encoder.0", C, 3)
    _ln(specs, p + "position_encoder.1", C)
    _linear(specs, p + "position_encoder.3", C, C)
    _ln(specs, p + "position_encoder.4", C)


def param_specs(model: dict):
    """The flagship's list with each decoder layer's cross-attention
    (`attentions.1.`) replaced, in place, by the MP module's tensors."""
    h = model["head"]
    specs, done = [], set()
    for name, shape, init in flagship.param_specs(model):
        at = name.find(".attentions.1.")
        if at < 0:
            specs.append((name, shape, init))
            continue
        p = name[:at + len(".attentions.1.")]
        if p not in done:
            done.add(p)
            cross_specs(specs, p, h)
    return specs


# --------------------------------------------------------------- forward
def query_graph(ref_pts, k):
    """(B, Q, k) indices of each query's k nearest other queries by the
    squared distance between reference points (B, Q, 3) in [0, 1]."""
    d2 = ((ref_pts[:, :, None, :] - ref_pts[:, None, :, :]) ** 2).sum(-1)
    self_pair = torch.eye(ref_pts.shape[1], dtype=torch.bool, device=d2.device)
    d2 = d2.masked_fill(self_pair, float("inf"))
    return torch.topk(d2, k, dim=-1, largest=False).indices


def project(pts, lidar2img, img_shape, eps=1e-5):
    """pts (B, R, 3) metric -> loc (B, N, R, 2) in [0, 1] of the image and
    valid (B, N, R) float: in front of the camera and inside the image."""
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    cam = torch.einsum("bnij,brj->bnri", lidar2img, hom)
    z = cam[..., 2:3]
    img_h, img_w = img_shape
    loc = cam[..., 0:2] / z.clamp(min=eps) / torch.tensor(
        [img_w, img_h], dtype=torch.float32, device=pts.device)
    valid = ((z > eps) & (loc[..., 0:1] > 0) & (loc[..., 0:1] < 1)
             & (loc[..., 1:2] > 0) & (loc[..., 1:2] < 1))[..., 0]
    return loc, valid.float()


def sample(v, shapes, pts, logits, lidar2img, img_shape, heads, levels,
           corners=False):
    """Every camera's deformable sampling of pts (B, R, heads, L, P, 3),
    metric, weighted by softmax(logits (B, R, heads, L P)) times the
    in-view mask: (B, N, R, C). `corners`: by `msda_corners`, not
    flagship.msda."""
    B, R = pts.shape[:2]
    P = pts.shape[4]
    N = lidar2img.shape[1]
    loc, valid = project(pts.reshape(B, -1, 3), lidar2img, img_shape)
    attn = torch.softmax(logits, dim=-1).view(B, 1, R, heads, levels, P)
    attn = attn * valid.view(B, N, R, heads, levels, P)
    out = (msda_corners if corners else msda)(
        v, shapes, loc.reshape(B * N, R, heads, levels, P, 2),
        attn.reshape(B * N, R, heads, levels, P))
    return out.view(B, N, R, -1)


def msda_corners(value, shapes, loc, attn):
    """flagship.msda with each (row, head)'s samples combined in one
    matrix product: the weights of its L x P x 4 corners (bilinear times
    attention, zero outside the image) times the values gathered at
    them. FlopCounterMode counts that product, 2 hd FLOPs a corner:
    K1's formula (flops/count.py), here for the neighbour branch, whose
    samples count.py's `k1_flops` does not hold."""
    BN, S, nh, hd = value.shape
    R, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    index, weight = [], []
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        px = loc[:, :, :, lvl, :, 0] * W - 0.5  # (BN, R, nh, P)
        py = loc[:, :, :, lvl, :, 1] * H - 0.5
        y0, x0 = torch.floor(py), torch.floor(px)
        fy, fx = py - y0, px - x0
        a = attn[:, :, :, lvl]
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                yy, xx = y0 + dy, x0 + dx
                inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                index.append(start + (yy.clamp(0, H - 1) * W
                                      + xx.clamp(0, W - 1)).long())
                weight.append(wy * wx * inside * a)
        start += H * W
    index = torch.stack(index, -1).permute(0, 2, 1, 3, 4).reshape(BN, nh, -1)
    weight = torch.stack(weight, -1).permute(0, 2, 1, 3, 4).reshape(
        BN, nh, R, 1, -1)  # (BN, nh, R, 1, 4 L P)
    v = value.permute(0, 2, 1, 3)  # (BN, nh, S, hd)
    g = torch.gather(v, 2, index[..., None].expand(-1, -1, -1, hd))
    out = torch.matmul(weight, g.view(BN, nh, R, 4 * L * P, hd))
    return out.view(BN, nh, R, hd).permute(0, 2, 1, 3).reshape(BN, R, nh * hd)


def cross_attention(ref, p, h, query, value, shapes, ref_pts, lidar2img,
                    img_shape):
    """The multi-point graph cross-attention of one decoder layer, its
    query graph built from ref_pts (B, Q, 3) in [0, 1]."""
    B, Q, C = query.shape
    nh, L, P, N, K = (h["num_heads"], h["num_levels"], h["num_points"],
                      h["num_cams"], h["num_neighbors"])
    pn = max(P // 4, 1)
    pc = torch.tensor(h["pc_range"], device=query.device)
    q = query  # no query_pos (:220-221)
    v = ref.linear(value, p + "value_proj").reshape(B * N, -1, nh, C // nh)
    cam_w = ref.linear(q, p + "cam_attention_weights")  # (B, Q, N)

    # centre branch
    metric = ref_pts * (pc[3:] - pc[:3]) + pc[:3]
    offsets = ref.linear(q, p + "deform_sampling_offsets").view(B, Q, nh, 1, P, 3)
    pts = metric[:, :, None, None, None, :] + offsets.expand(B, Q, nh, L, P, 3)
    centre = sample(v, shapes, pts,
                    ref.linear(q, p + "attention_weights").view(B, Q, nh, L * P),
                    lidar2img, img_shape, nh, L)
    gate = torch.sigmoid(cam_w).reshape(B, N, Q, 1)  # (B, Q, N) memory
    centre = (centre * gate).sum(1)

    # neighbour branch: row j Q + q is query q's j-th nearest neighbour
    idx = query_graph(ref_pts, K)  # (B, Q, K)
    nbr = metric[torch.arange(B, device=idx.device)[:, None, None], idx]
    nbr = nbr.transpose(1, 2).reshape(B, K * Q, 3)
    pts_n = nbr[:, :, None, None, None, :].expand(B, K * Q, nh, L, pn, 3)
    logits_n = ref.linear(q, p + "attention_weights_neighbor").view(B, 1, Q, -1)
    nb = sample(v, shapes, pts_n, logits_n.expand(B, K, Q, nh * L * pn)
                .reshape(B, K * Q, nh, L * pn), lidar2img, img_shape, nh, L,
                corners=True)
    gate_n = cam_w[:, None].expand(B, K, Q, N).reshape(B, N, K * Q, 1)  # raw
    nb = (nb * gate_n).sum(1).view(B, K, Q, C).sum(1)

    # the learned 2-way fusion, one pair of weights a sample
    fuse = ref.linear(torch.cat([centre, nb], -1), p + "output_weight")
    fuse = torch.softmax(fuse.sum(1), dim=-1)  # (B, 2)
    out = centre * fuse[:, None, 0:1] + nb * fuse[:, None, 1:2]
    out = ref.linear(out, p + "output_proj")
    pos = inverse_sigmoid(ref_pts)
    for i in (0, 3):
        pos = torch.relu(ref.layer_norm(ref.linear(pos, f"{p}position_encoder.{i}"),
                                        f"{p}position_encoder.{i + 1}"))
    return out + query + pos


def first_reference_points(ref, model):
    """(1, Q, 3) in [0, 1]: the reference points entering the first
    decoder layer, the sigmoid of the projection of the query table's
    positional half; the same for every request."""
    C = model["head"]["embed_dims"]
    table = ref.p("pts_bbox_head.query_embedding.weight")
    return torch.sigmoid(ref.linear(table[None, :, :C],
                                    "pts_bbox_head.transformer.reference_points"))


def head(ref, model, feats, lidar2img):
    """Detr3DHeadPE with the MP cross-attention over L x (B, N, h, w, C)
    features: every decoder layer's class logits (layers, B, Q, classes)
    and box codes (layers, B, Q, 10), as flagship.head."""
    h = model["head"]
    img_shape = tuple(model["img_size"])
    pre = "pts_bbox_head."
    lidar2img = lidar2img.float()
    B, N = feats[0].shape[:2]
    C = h["embed_dims"]
    dev = feats[0].device
    depth = lid_bins(h["depth_num"], h["depth_start"], h["pc_range"][3], dev)
    values, shapes = [], []
    for f in feats:
        f = f.float()
        _, _, H, W, _ = f.shape
        pe = ref.mlp2(coords_3d(lidar2img, H, W, img_shape, depth,
                                h["pc_range"]), pre + "position_encoder")
        pe = ref.se(pe, f, pre + "fpe")
        sin = sine_pe_3d(B, N, H, W, h["pe_num_feats"], -0.5, dev)
        pe = pe + ref.mlp2(sin, pre + "adapt_pos3d")
        values.append((f + pe).reshape(B, N, H * W, C))
        shapes.append((H, W))
    value = torch.cat(values, dim=2)

    table = ref.p(pre + "query_embedding.weight")
    query_pos = table[None, :, :C].expand(B, -1, -1)
    query = table[None, :, C:].expand(B, -1, -1)
    ref_pts = first_reference_points(ref, model).expand(B, -1, -1)
    pc = h["pc_range"]
    cls_all, box_all = [], []
    for lid in range(h["num_decoder_layers"]):
        p = f"{pre}transformer.decoder.layers.{lid}."
        qk = query + query_pos
        query = ref.layer_norm(
            query + ref.mha(qk, qk, query, p + "attentions.0.attn", h["num_heads"]),
            p + "norms.0")
        query = ref.layer_norm(cross_attention(
            ref, p + "attentions.1.", h, query, value, shapes, ref_pts,
            lidar2img, img_shape), p + "norms.1")
        query = ref.layer_norm(ref.ffn(query, p + "ffns.0"), p + "norms.2")

        c = f"{pre}cls_branches.{lid}."
        x = query
        for i in (0, 3):
            x = torch.relu(ref.layer_norm(ref.linear(x, c + str(i)), c + str(i + 1)))
        cls_all.append(ref.linear(x, c + "6"))
        r = f"{pre}reg_branches.{lid}."
        t = torch.relu(ref.linear(torch.relu(ref.linear(query, r + "0")), r + "2"))
        t = ref.linear(t, r + "4")
        ris = inverse_sigmoid(ref_pts)
        xy = torch.sigmoid(t[..., 0:2] + ris[..., 0:2])
        z = torch.sigmoid(t[..., 4:5] + ris[..., 2:3])
        box_all.append(torch.cat([
            xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
            xy[..., 1:2] * (pc[4] - pc[1]) + pc[1], t[..., 2:4],
            z * (pc[5] - pc[2]) + pc[2], t[..., 5:]], dim=-1))
        ref_pts = torch.cat([xy, z], dim=-1)
    return torch.stack(cls_all), torch.stack(box_all)


def forward_feats(ref, model, feats, lidar2img, extras):
    return head(ref, model, feats, lidar2img)
