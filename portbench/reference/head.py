"""Plain CLIP-SPM head (HSMR motion refinement, SPM semantic prototype
modulation, PADM task modulation; hnlxy/CLIP-SPM, ``configs/clipspm/
hmdb.yaml``) and its OTAM distances and episodic loss, as functions of a
state dict with keys ``head.<module>.<param>``.

In float32, with ``prec`` rounding the operands of every product
(``clip.py``). OTAM is the plain recurrence: a zero-padded column on each
side of each ``[L, M]`` cosine-distance table, the top row a cumulative
sum, every other cell its distance plus the soft-min (temperature 0.5) of
its up-left and left neighbours, with the up neighbour too in the first and
last real columns; both directions summed. Dropout (training only) takes
its masks from ``masks``, a callable that returns the keep mask of the
next dropout in the head's order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .clip import Params, Prec, _ident, linear

Masks = Optional[Callable[[tuple, float], torch.Tensor]]


# ---------------------------------------------------------------------------
# OTAM
# ---------------------------------------------------------------------------

def _smin(xs, lbda: float):
    m = xs[0]
    for x in xs[1:]:
        m = torch.minimum(m, x)
    return m - lbda * torch.log(sum(torch.exp(-(x - m) / lbda) for x in xs))


def otam_cum(tables: torch.Tensor, lbda: float = 0.5) -> torch.Tensor:
    """``[..., L, Ms]`` distance tables -> ``[...]``, row by row."""
    D = F.pad(tables, (1, 1))
    M = D.shape[-1]
    zero = torch.zeros_like(D[..., 0, 0])
    prev = torch.cumsum(D[..., 0, :], dim=-1)
    for l in range(1, D.shape[-2]):
        row = [zero, D[..., l, 1] + _smin([prev[..., 0], prev[..., 1], zero],
                                          lbda)]
        for m in range(2, M - 1):
            row.append(D[..., l, m] + _smin([prev[..., m - 1], row[m - 1]],
                                            lbda))
        row.append(D[..., l, M - 1] + _smin(
            [prev[..., M - 2], prev[..., M - 1], row[M - 2]], lbda))
        prev = torch.stack(row, dim=-1)
    return prev[..., -1]


def otam_distance(support, query, prec: Prec = _ident, lbda: float = 0.5,
                  eps: float = 0.01) -> torch.Tensor:
    """Bidirectional OTAM distances ``[Q, S]`` of ``[S, L, D]`` and
    ``[Q, L, D]`` frame features (cosine distance, ``eps`` in the norm
    product)."""
    S, Ls, D = support.shape
    Q, Lq, _ = query.shape
    qf, sf = query.reshape(Q * Lq, D), support.reshape(S * Ls, D)
    num = torch.matmul(prec(qf), prec(sf).t())
    den = (torch.linalg.vector_norm(qf, dim=-1)[:, None]
           * torch.linalg.vector_norm(sf, dim=-1)[None, :]) + eps
    tab = (1.0 - num / den).reshape(Q, Lq, S, Ls).permute(0, 2, 1, 3)
    return otam_cum(tab, lbda) + otam_cum(tab.transpose(-2, -1), lbda)


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

class Head:
    """The clipspm head over frame features, for one episode."""

    def __init__(self, P: Params, spm: Dict[str, float], way: int, shot: int,
                 train: bool = False, prec: Prec = _ident,
                 masks: Masks = None):
        self.P, self.spm, self.way, self.shot = P, spm, way, shot
        self.train, self.prec, self.masks = train, prec, masks

    def _lin(self, x, key, bias=True):
        P = self.P
        return linear(x, P[f"head.{key}.weight"],
                      P[f"head.{key}.bias"] if bias else None, self.prec)

    def _drop(self, x, p: float):
        if not self.train:
            return x
        keep = self.masks(tuple(x.shape), p)
        return x * keep.to(x.dtype) * (1.0 / (1.0 - p))

    def _ff(self, x, key, p):
        h = self._drop(F.gelu(self._lin(x, f"{key}.fc1")), p)
        return self._drop(self._lin(h, f"{key}.fc2"), p)

    def _ln(self, x, key):
        return F.layer_norm(x, x.shape[-1:], self.P[f"head.{key}.weight"],
                            self.P[f"head.{key}.bias"], 1e-5)

    def _transformer(self, x, key):
        """One pre-norm self-attention block (8 heads of 256, attention
        dropout 0.2, feed-forward dropout 0.05)."""
        h = self._ln(x, f"{key}.norm_0")
        heads, dh = 8, 256
        b, n, _ = h.shape

        def split(t):
            return t.reshape(b, n, heads, dh).transpose(1, 2)

        q = split(self._lin(h, f"{key}.attn_0.to_q", False))
        k = split(self._lin(h, f"{key}.attn_0.to_k", False))
        v = split(self._lin(h, f"{key}.attn_0.to_v", False))
        prec = self.prec
        a = torch.softmax(torch.matmul(prec(q), prec(k).transpose(-1, -2))
                          * dh ** -0.5, dim=-1)
        o = torch.matmul(prec(a), prec(v)).transpose(1, 2).reshape(
            b, n, heads * dh)
        x = self._drop(self._lin(o, f"{key}.attn_0.to_out"), 0.2) + x
        return self._ff(x, f"{key}.ff_0", 0.05) + x

    def _gate(self, x, which):
        h = F.leaky_relu(self._lin(x, f"gate_{which}_fc1"),
                         negative_slope=self.spm["negative_slope"])
        return torch.sigmoid(self._lin(h, f"gate_{which}_fc2"))

    def _se_te(self, frames, token):
        fused = (token * self._gate(token, "text") * self.spm["alpha"]
                 + frames * self._gate(frames, "vision"))
        x = self._transformer(torch.cat([token, fused], dim=1), "context2")
        return x[:, 1:], x[:, :1]

    def _conv1d(self, x, key):
        P = self.P
        return F.conv1d(self.prec(x), self.prec(P[f"head.{key}.weight"]),
                        P[f"head.{key}.bias"], padding=1)

    def _motion(self, feats):
        conv = self._conv1d(self._conv1d(feats.transpose(1, 2),
                                         "motion_conv1"), "motion_conv2")
        conv = conv.transpose(1, 2)
        fwd = conv[:, 1:] - feats[:, :-1]
        bwd = conv[:, :-1] - feats[:, 1:]
        return (0.5 * (fwd + bwd)).mean(dim=1)

    @staticmethod
    def _dis(x, y):
        d = x - y
        return (d * d).sum(dim=-1).mean()

    def _prototypes(self, feats, labels):
        return torch.stack([feats[labels == c].mean(dim=0)
                            for c in range(self.way)])

    def forward(self, su, qu, labels, ctx_s, ctx_q):
        """``su [S, T, D]``, ``qu [Q, T, D]`` features, ``labels [S]``,
        text rows ``ctx_s [S, 1, D]`` and ``ctx_q [Q, 1, D]``. Returns
        ``(logits [Q, way], aux distance)``."""
        way, shot = self.way, self.shot
        labels = labels.long()
        # HSMR
        su_mo, qu_mo = self._motion(su), self._motion(qu)
        qu_m, qu_tok = self._se_te(qu, qu_mo[:, None])
        su_m, su_tok = self._se_te(su, su_mo[:, None])
        mo_dist = (self._dis(self._motion(qu_m), qu_tok[:, 0])
                   + self._dis(self._motion(su_m), su_tok[:, 0]))
        # SPM
        token = torch.cat([ctx_q, ctx_s], dim=0).mean(dim=0, keepdim=True)
        s_tok = self._ff(token * su.mean(dim=(1, 2), keepdim=True),
                         "token_tr", 0.05)
        q_tok = self._ff(token * qu.mean(dim=(1, 2), keepdim=True),
                         "token_tr", 0.05)
        self._se_te(qu, ctx_q)
        self._se_te(su, s_tok)
        qu_fake, _ = self._se_te(qu, q_tok)
        su_real, _ = self._se_te(su, ctx_s)
        class_dists = otam_distance(self._prototypes(su_real, labels),
                                    qu_fake, self.prec)
        # PADM
        order = torch.argsort(labels, stable=True)
        suu = su_real[order].reshape((way, shot) + su_real.shape[1:])
        q_rep = qu_fake[None].expand((way,) + tuple(qu_fake.shape))
        tok_s = torch.cat([suu, q_rep], dim=1).mean(dim=1)
        tok_q = tok_s.mean(dim=0, keepdim=True)
        su_t = self._transformer(torch.cat([tok_s, su_real]).transpose(0, 1),
                                 "context1").transpose(0, 1)
        qu_t = self._transformer(torch.cat([tok_q, qu_fake]).transpose(0, 1),
                                 "context1").transpose(0, 1)
        task = (otam_distance(self._prototypes(su_t[way:], labels),
                              qu_t[1:], self.prec)
                + otam_distance(su_t[:way], qu_t[:1], self.prec))
        logits = -(0.5 * class_dists + task)
        return logits, self.P["head.mo_alpha1"] * mo_dist


def episode_loss(logits, target_labels, aux, tasks_per_batch: int):
    """The clipspm episode loss: the summed query cross-entropy over
    ``tasks_per_batch``, plus 0.001 times the aux distance; and the
    accuracy."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, target_labels.long()[:, None]).sum()
    acc = (logits.argmax(dim=-1) == target_labels.long()).float().mean()
    return ce / float(tasks_per_batch) + 0.001 * aux, acc


def head_specs(dim: int, spm: Dict[str, float]) -> list:
    """The head's keys, shapes and initial distributions (lecun-normal
    kernels, zero biases, norms at identity, scalar gains at 1)."""
    out: list = []

    def lin(key, cin, cout, bias=True):
        out.append((f"head.{key}.weight", (cout, cin), "normal", cin ** -0.5))
        if bias:
            out.append((f"head.{key}.bias", (cout,), "zeros", 0.0))

    for k in ("motion_conv1", "motion_conv2"):
        out.append((f"head.{k}.weight", (dim, dim, 3), "normal",
                    (3 * dim) ** -0.5))
        out.append((f"head.{k}.bias", (dim,), "zeros", 0.0))
    lin("token_tr.fc1", dim, 2048)
    lin("token_tr.fc2", 2048, dim)
    for c in ("context1", "context2"):
        out.append((f"head.{c}.norm_0.weight", (dim,), "ones", 0.0))
        out.append((f"head.{c}.norm_0.bias", (dim,), "zeros", 0.0))
        for p in ("to_q", "to_k", "to_v"):
            lin(f"{c}.attn_0.{p}", dim, 2048, bias=False)
        lin(f"{c}.attn_0.to_out", 2048, dim)
        lin(f"{c}.ff_0.fc1", dim, 2048)
        lin(f"{c}.ff_0.fc2", 2048, dim)
    out.append(("head.mo_alpha1", (), "ones", 0.0))
    out.append(("head.scale", (), "ones", 0.0))
    t, v = int(dim * spm["mid_dim_text"]), int(dim * spm["mid_dim_vision"])
    lin("gate_text_fc1", dim, t)
    lin("gate_text_fc2", t, dim)
    lin("gate_vision_fc1", dim, v)
    lin("gate_vision_fc2", v, dim)
    return out

