"""The plain reference of the served and trained model, in float32.

A frozen, independent restatement of EGO-Moment-CLE-ViT's mathematics: a
backbone of the configuration's family (``families/<family>.py``), graph
polynomial fusion of the two views' token Grams, the graph-weighted moment
head (iSQRT-COV on the dense route for N >= D or in the token subspace for
N < D, paired vech, Tensor-Sketch third order) and the 'add' or 'multiscale'
classifier, with the five-term loss.  Parameter and buffer names are the
measured program's, so one state dict loads into both.  It imports nothing
of the program: every product is a plain float32 ``torch`` operation (TF32
off, see ``fp32_products``).

``precision='fp8'`` is the control (``layers.py``): every product that the
configuration runs in bfloat16 takes its operands rounded to float8 e4m3.
Products the configuration runs in float32 (the heads' Grams, the iSQRT
iteration, the sketch) stay float32.

The backbone runs on ``chunk`` images at a time, so the attention of
ViT-L/16 at 448 (785 tokens, 16 heads) fits at batch 64; training recomputes
each chunk for its backward (``RefModel.loss_and_grads``).
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import Dense, LayerNorm, dropout, dropout_mask


class Backbone(nn.Module):
    """The program's nesting (``backbone.backbone.<MODULE>``) of the net of
    the configuration's family, ``families/<architecture.family>.py``."""

    def __init__(self, arch: dict, precision: str):
        super().__init__()
        self.family = importlib.import_module(f"h100_bench.reference.families.{arch['family']}")
        self.add_module(self.family.MODULE, self.family.Net(arch, precision))

    @property
    def net(self):
        return getattr(self, self.family.MODULE)

    def features(self, tokens):
        """Final tokens -> (patch tokens [B, N, D], global feature [B, D])."""
        return self.family.features(tokens)


class DualStream(nn.Module):
    def __init__(self, arch, precision):
        super().__init__()
        self.backbone = Backbone(arch, precision)


# ----------------------------------------------------------------------------
# heads: GPF, moment head, classifiers
# ----------------------------------------------------------------------------


def gram(tokens, similarity: str, eps: float = 1e-6):
    if similarity == "cosine":
        tokens = tokens / tokens.norm(dim=-1, keepdim=True).clamp(min=eps)
    return torch.matmul(tokens, tokens.transpose(-1, -2))


def gpf_fuse(r_a, r_p, coeffs):
    """sym(sum_pq c_pq A_p(R_a) * A_q(R_p)) clamped at 0, A_0 = 1, A_1 = R,
    A_k = R clamp(R, 0)^(k-1)."""
    def powers(r, n):
        out, cur = [torch.ones_like(r)], torch.ones_like(r)
        for k in range(n):
            cur = cur * (r if k == 0 else r.clamp(min=0.0))
            out.append(cur)
        return out
    pa, pp = powers(r_a, coeffs.shape[0] - 1), powers(r_p, coeffs.shape[1] - 1)
    fused = sum(coeffs[p, q] * pa[p] * pp[q]
                for p in range(coeffs.shape[0]) for q in range(coeffs.shape[1]))
    return (0.5 * (fused + fused.transpose(-1, -2))).clamp(min=0.0)


class GPF(nn.Module):
    def __init__(self, p: int, q: int, similarity: str):
        super().__init__()
        self.similarity = similarity
        self.alpha_coeffs = nn.Parameter(torch.empty(p + 1, q + 1))

    def forward(self, tokens_a, tokens_p):
        return gpf_fuse(gram(tokens_a, self.similarity), gram(tokens_p, self.similarity),
                        F.softplus(self.alpha_coeffs))


def paired_vech(m):
    """The upper triangle in the paired order: row i beside row D-1-i reversed."""
    d = m.shape[-1]
    flat = F.pad(m.reshape(*m.shape[:-2], d * d), (0, d)).reshape(*m.shape[:-2], d, d + 1)
    rows = torch.arange(d, device=m.device)[:, None]
    cols = torch.arange(d + 1, device=m.device)[None, :]
    u = torch.where(cols < d - rows, flat, torch.zeros((), device=m.device))
    packed = u[..., : d // 2, :] + torch.flip(u[..., d // 2:, :], dims=(-2, -1))
    return packed.reshape(*m.shape[:-2], d * (d + 1) // 2)


def isqrt_subspace(a, b, iterations: int, eps: float):
    """(A^T B)^-1/2 for N < D by the coupled Newton–Schulz iteration in the
    N-dimensional token subspace (A = centred tokens, B = W A)."""
    n = a.shape[-2]
    trace = torch.sum(a * b, dim=(-2, -1))[..., None, None]
    bh = b / (trace + eps)
    s = torch.matmul(bh, a.transpose(-1, -2))
    eye = torch.eye(n, device=a.device)
    a_k, g = 1.0, torch.zeros_like(s)
    for _ in range(iterations):
        sg = torch.matmul(s, g)
        h = (a_k * a_k) * eye + torch.matmul(s, 2.0 * a_k * g + torch.matmul(g, sg))
        g = 1.5 * g - 0.5 * (a_k * h + torch.matmul(g, torch.matmul(s, h)))
        a_k = 1.5 * a_k
    out = torch.matmul(a.transpose(-1, -2), torch.matmul(g, bh))
    out = out + a_k * torch.eye(a.shape[-1], device=a.device)
    return out / torch.sqrt(trace + eps)


def isqrt_dense(a, b, iterations: int, eps: float):
    """(A^T B)^-1/2 for N >= D: M = A^T B formed D x D in float32, then
    ``newton_schulz``."""
    return newton_schulz(torch.matmul(a.transpose(-1, -2), b), iterations, eps)


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest), in float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def newton_schulz(m, iterations: int, eps: float, precision: str = "fp32"):
    """M^-1/2 by the coupled Newton–Schulz iteration of iSQRT-COV (Li et al.
    2018) on the trace-normalised M: Z = M / (tr + eps), Y = I; each step
    T = Z Y, Y <- 1.5 Y - 0.5 Y T, Z <- 1.5 Z - 0.5 T^T Z; then
    Y / sqrt(tr + eps).  In float32; ``precision`` names a control: 'bf16'
    stores Z, T and Y in bfloat16 (float32 sums), 'tf32' rounds every
    product's operands to TF32."""
    keep = (lambda t: t.to(torch.bfloat16).float()) if precision == "bf16" else (lambda t: t)
    mul = (lambda x, y: torch.matmul(tf32(x), tf32(y))) if precision == "tf32" else torch.matmul
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None] + eps
    z = keep(m / trace)
    y = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
    for _ in range(iterations):
        t = keep(mul(z, y))
        y, z = (keep(1.5 * y - 0.5 * mul(y, t)),
                keep(1.5 * z - 0.5 * mul(t.transpose(-1, -2), z)))
    return y / torch.sqrt(trace)


def graph_centre(tokens, graph, eps: float, keep=lambda t: t):
    """The head's graph weighting: W = D^-1/2 G D^-1/2, its row sums and
    trace, and the tokens centred on mu = Z^T W 1 / tr(W); ``keep`` rounds mu
    and the centred tokens where the head stores them."""
    deg = graph.sum(dim=-1)
    inv = torch.rsqrt(deg.clamp(min=eps))
    w = graph * inv[..., :, None] * inv[..., None, :]
    trace_w = torch.diagonal(w, dim1=-2, dim2=-1).sum(-1)[..., None]
    rows = w.sum(dim=-1)
    mu = keep(torch.einsum("bnd,bn->bd", tokens, rows) / (trace_w + eps))
    return w, rows, trace_w, keep(tokens - mu[:, None])


def dense_route_isqrt(tokens, graph, iterations: int, eps: float = 1e-5, stored=None,
                      precision: str = "fp32"):
    """The moment head's M2^-1/2 on the dense route from the head's inputs
    (tokens [B, N, D], graph [B, N, N]): centred tokens Zc, W Zc, M = Zc^T (W
    Zc) and ``newton_schulz``, each formed in float32.  ``stored`` (the
    model's dtype, where it is not float32) rounds to it what the head keeps
    in it: mu, Zc, W Zc, M and M^-1/2."""
    keep = (lambda t: t.to(stored).float()) if stored is not None else (lambda t: t)
    w, _, _, centered = graph_centre(tokens.float(), graph.float(), eps, keep)
    m = keep(torch.matmul(centered.transpose(-1, -2), keep(torch.matmul(w, centered))))
    return keep(newton_schulz(m, iterations, eps, precision))


def sketch_dim(d: int, sketch: int, cap: int = 4) -> int:
    return -(-min(sketch, cap * d) // 128) * 128


class MomentHead(nn.Module):
    HEAD_EPS = 1e-6

    def __init__(self, d: int, d_out: int, iterations: int, sketch: int, p_drop: float,
                 precision: str, eps: float = 1e-5):
        super().__init__()
        self.iterations, self.eps, self.p_drop = iterations, eps, p_drop
        half = d_out // 2
        self.second_proj = Dense(d * (d + 1) // 2, half, precision)
        self.second_norm = LayerNorm(half, self.HEAD_EPS)
        k = sketch_dim(d, sketch)
        self.register_buffer("sketch_matrices", torch.empty(3, d, k))
        self.third_proj = Dense(k, d_out - half, precision)
        self.third_norm = LayerNorm(d_out - half, self.HEAD_EPS)

    def forward(self, tokens, graph, generator=None):
        n, d = tokens.shape[-2:]
        eps = self.eps
        w, rows, trace_w, centered = graph_centre(tokens, graph, eps)
        isqrt = isqrt_dense if n >= d else isqrt_subspace
        m2 = isqrt(centered, torch.matmul(w, centered), self.iterations, eps)
        x = F.gelu(self.second_norm(self.second_proj(paired_vech(m2))))
        x = dropout(x, self.p_drop, self.training, generator)
        pooled = torch.einsum("bnd,bn->bd", centered, rows) / (trace_w + eps)
        s = [torch.matmul(pooled, self.sketch_matrices[i]) for i in range(3)]
        f = torch.fft.rfft(s[0]) * torch.fft.rfft(s[1]) * torch.fft.rfft(s[2])
        third = torch.fft.irfft(f, n=self.sketch_matrices.shape[-1])
        y = F.gelu(self.third_norm(self.third_proj(third)))
        y = dropout(y, self.p_drop, self.training, generator)
        return torch.cat([x, y], dim=-1)


class AddClassifier(nn.Module):
    """'add' fusion (projected where the widths differ), then fc1 -> norm ->
    GELU -> drop -> fc2 -> norm -> GELU -> drop -> fc_out."""

    def __init__(self, d_cls, d_moment, classes, p_drop, precision):
        super().__init__()
        self.p_drop = p_drop
        self.project = d_cls != d_moment
        if self.project:
            self.cls_proj = Dense(d_cls, d_moment, precision)
            self.moment_proj = Dense(d_moment, d_moment, precision)
        hidden = max(d_moment // 2, 256)
        self.fc1 = Dense(d_moment, hidden, precision)
        self.norm1 = LayerNorm(hidden, MomentHead.HEAD_EPS)
        self.fc2 = Dense(hidden, hidden // 2, precision)
        self.norm2 = LayerNorm(hidden // 2, MomentHead.HEAD_EPS)
        self.fc_out = Dense(hidden // 2, classes, precision)

    def forward(self, cls, moments, generator=None):
        x = self.cls_proj(cls) + self.moment_proj(moments) if self.project else cls + moments
        x = dropout(F.gelu(self.norm1(self.fc1(x))), self.p_drop, self.training, generator)
        x = dropout(F.gelu(self.norm2(self.fc2(x))), self.p_drop, self.training, generator)
        return self.fc_out(x)


class ScaleAttention(nn.Module):
    def __init__(self, dim, precision):
        super().__init__()
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim, precision))

    def forward(self, x):
        logits = torch.matmul(self.query(x) / math.sqrt(x.shape[-1]), self.key(x).transpose(-1, -2))
        return self.out(torch.matmul(torch.softmax(logits, dim=-1), self.value(x)))


class MultiScaleClassifier(nn.Module):
    """Three scales i: [cls_proj_i(cls), moment_proj_i(m)] -> scale_fc_i ->
    norm -> GELU -> drop -> scale_out_i; attention over the three logits, mean."""

    def __init__(self, d_cls, d_moment, classes, p_drop, precision, scales: int = 3):
        super().__init__()
        self.p_drop, self.scales = p_drop, scales
        for i in range(scales):
            c, m = d_cls // 2 ** i, d_moment // 2 ** i
            setattr(self, f"cls_proj_{i}", Dense(d_cls, c, precision))
            setattr(self, f"moment_proj_{i}", Dense(d_moment, m, precision))
            setattr(self, f"scale_fc_{i}", Dense(c + m, (c + m) // 2, precision))
            setattr(self, f"scale_norm_{i}", LayerNorm((c + m) // 2, MomentHead.HEAD_EPS))
            setattr(self, f"scale_out_{i}", Dense((c + m) // 2, classes, precision))
        self.scale_attention = ScaleAttention(classes, precision)

    def forward(self, cls, moments, generator=None):
        logits = []
        for i in range(self.scales):
            x = torch.cat([getattr(self, f"cls_proj_{i}")(cls),
                           getattr(self, f"moment_proj_{i}")(moments)], dim=-1)
            x = F.gelu(getattr(self, f"scale_norm_{i}")(getattr(self, f"scale_fc_{i}")(x)))
            logits.append(getattr(self, f"scale_out_{i}")(
                dropout(x, self.p_drop, self.training, generator)))
        return self.scale_attention(torch.stack(logits, dim=1)).mean(dim=1)


# ----------------------------------------------------------------------------
# the model and its loss
# ----------------------------------------------------------------------------


def cross_entropy(logits, labels):
    return -torch.gather(F.log_softmax(logits, dim=-1), 1, labels[:, None].long())[:, 0].mean()


def roll_triplet(anchor, positive, margin):
    """Squared distances of unit features; the negative of i is anchor i-1."""
    a = anchor / anchor.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    p = positive / positive.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    n = torch.roll(a, 1, dims=0)
    pos, neg = ((a - p) ** 2).sum(-1), ((a - n) ** 2).sum(-1)
    return (pos - neg + margin).clamp(min=0.0).mean()


def alignment_mse(graph_means, labels):
    same = (labels[:, None] == labels[None, :]).float()
    return torch.mean((torch.sigmoid(torch.outer(graph_means, graph_means)) - same) ** 2)


class RefModel(nn.Module):
    """The whole model.  ``spec`` is a configuration file's content."""

    def __init__(self, spec: dict, precision: str = "fp32"):
        super().__init__()
        arch, mcfg = spec["architecture"], spec["port_config"]["model"]
        tcfg = spec["port_config"].get("training", {})
        loss = tcfg.get("loss", {})
        gpf, moment = mcfg.get("gpf", {}), mcfg.get("moment", {})
        classifier = mcfg.get("classifier", {})
        self.chunk = spec["reference_chunk"]
        self.lambda_triplet = loss.get("lambda_triplet", 1.0)
        self.lambda_align = loss.get("lambda_align", 0.1)
        self.margin = loss.get("margin", 0.3)
        self.p_drop = classifier.get("dropout", 0.1)
        d = arch["num_features"]
        d_out = moment.get("d_out", 1024)
        classes = spec["num_classes"]
        self.backbone = DualStream(arch, precision)
        self.gpf = GPF(gpf.get("degree_p", 2), gpf.get("degree_q", 2),
                       gpf.get("similarity", "cosine"))
        self.moment_head = MomentHead(d, d_out, moment.get("isqrt_iterations", 5),
                                      moment.get("sketch_dim", 4096), self.p_drop, precision)
        if classifier.get("type", "standard") == "multiscale":
            self.classifier = MultiScaleClassifier(d, d_out, classes, self.p_drop, precision)
        elif classifier.get("fusion_type", "concat") == "add":
            self.classifier = AddClassifier(d, d_out, classes, self.p_drop, precision)
        else:
            raise NotImplementedError("only the 'add' and 'multiscale' classifiers have a "
                                      "reference here")
        self.cls_only_classifier = Dense(d, classes, precision)

    @property
    def net(self):
        return self.backbone.backbone.net

    # -- the backbone in chunks ------------------------------------------------

    def tokens(self, images, mask=None):
        """Final backbone tokens of ``images``, ``chunk`` images at a time;
        ``mask``: the dropout keep mask (already scaled) for the whole batch."""
        out = []
        for lo in range(0, images.shape[0], self.chunk):
            x = self.net.stem(images[lo:lo + self.chunk])
            if mask is not None:
                x = x * mask[lo:lo + self.chunk]
            out.append(self.net.body(x))
        return torch.cat(out)

    def heads(self, tokens_a, tokens_p, global_a, generator=None):
        graph = self.gpf(tokens_a, tokens_p)
        moments = self.moment_head(tokens_a, graph, generator)
        return self.classifier(global_a, moments, generator), graph

    @torch.no_grad()
    def infer(self, images):
        """Serving: one view, R_p := R_a -> logits."""
        self.eval()
        patch, glob = self.backbone.backbone.features(self.tokens(images))
        return self.heads(patch, patch, glob)[0]

    def loss_terms(self, feats_a, feats_p, labels, generator):
        (ta, ga), (tp, gp) = feats_a, feats_p
        logits, graph = self.heads(ta, tp, ga, generator)
        terms = {"loss_main_ce": cross_entropy(logits, labels),
                 "loss_anchor_ce": cross_entropy(self.cls_only_classifier(ga), labels),
                 "loss_positive_ce": cross_entropy(self.cls_only_classifier(gp), labels)}
        if self.lambda_triplet > 0:
            terms["loss_triplet"] = self.lambda_triplet * roll_triplet(ga, gp, self.margin)
        if self.lambda_align > 0:
            terms["loss_align"] = self.lambda_align * alignment_mse(graph.mean(dim=(1, 2)),
                                                                    labels)
        return terms

    def loss_and_grads(self, anchor, positive, labels, generator):
        """The training forward and backward on [anchor; positive].  The
        backbone runs without a graph first; the heads and the loss then take
        its tokens as leaves, and each chunk is run again with a graph and
        given its tokens' gradient.  Returns the loss (a float tensor)."""
        self.train()
        self.zero_grad(set_to_none=True)
        images = torch.cat([anchor, positive])
        b = anchor.shape[0]
        with torch.no_grad():
            stem_shape = (images.shape[0],) + tuple(self.net.stem(images[:1]).shape[1:])
        mask = dropout_mask(stem_shape, self.p_drop, generator, images.device)
        with torch.no_grad():
            toks = self.tokens(images, mask)
        toks.requires_grad_(True)
        bb = self.backbone.backbone
        terms = self.loss_terms(bb.features(toks[:b]), bb.features(toks[b:]), labels, generator)
        loss = sum(terms.values())
        loss.backward()
        dtoks = toks.grad
        for lo in range(0, images.shape[0], self.chunk):
            x = self.net.stem(images[lo:lo + self.chunk]) * mask[lo:lo + self.chunk]
            self.net.body(x).backward(dtoks[lo:lo + self.chunk])
        return loss.detach()
