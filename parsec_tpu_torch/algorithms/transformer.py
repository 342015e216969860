"""Transformer block (multi-head attention + FFN) as a PTG taskpool.

Port of the reference package's ``algorithms/transformer.py``. Attention
is a *streaming online-softmax chain over KV tiles* — per (head h, query
tile i), task ATT(h,i,j) folds KV tile j into a running (accumulator,
row-max, row-sum) state:

    ATT(h,i,0) → ATT(h,i,1) → ... → ATT(h,i,T-1) → NORM(h,i)

Head outputs are gathered per query tile (GATH chain over heads), output
projected, then a 2-layer FFN with residuals; results land in the ``Y``
collection. ATT has a CUDA incarnation that runs the hand-written flash
kernel on each (Q tile, KV tile) pair and merges its ``(o, lse)`` into
the chain state; the generic torch body serves every other device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..data.collection import DataCollection, LocalCollection
from ..dsl import ptg
from ..ops.flash_attention import flash_attention, merge_attention_states
from ..ops.precision import apply_matmul_precision


def build_transformer_block(Qc: DataCollection, Kc: DataCollection,
                            Vc: DataCollection, Y: DataCollection,
                            n_heads: int, n_tiles: int, tile_s: int,
                            d_head: int, Wo, W1, W2) -> ptg.Taskpool:
    """Attention+FFN taskpool.

    ``Qc/Kc/Vc`` hold per-(head, seq-tile) tiles of shape
    ``(tile_s, d_head)`` keyed ``(h, i)``; ``Y`` receives per-seq-tile
    block outputs keyed ``(i,)``. ``Wo`` is ``(H·dh, D)``, ``W1/W2`` the
    FFN weights (``(D, F)`` / ``(F, D)``), as tensors on the device the
    block runs on (see :func:`params_from_reference`)."""
    scale = 1.0 / math.sqrt(d_head)
    tp = ptg.Taskpool("transformer", Qc=Qc, Kc=Kc, Vc=Vc, Y=Y,
                      H=n_heads, T=n_tiles, TS=tile_s, DH=d_head,
                      Wo=Wo, W1=W1, W2=W2)

    def _init_state(g, h, i, j):
        # made on the CPU; a CUDA device stages it with the other inputs
        return (torch.zeros((g.TS, g.DH), dtype=torch.float32),    # acc
                torch.full((g.TS,), -math.inf, dtype=torch.float32),  # max
                torch.zeros((g.TS,), dtype=torch.float32))         # sum

    ATT = tp.task_class(
        "ATT", params=("h", "i", "j"),
        space=lambda g: ((h, i, j) for h in range(g.H)
                         for i in range(g.T) for j in range(g.T)),
        affinity=lambda g, h, i, j: (g.Kc, (h, j)),   # owner of the KV tile
        priority=lambda g, h, i, j: g.T - j,
        flows=[
            ptg.FlowSpec(
                "Q", ptg.READ,
                tile=lambda g, h, i, j: (g.Qc, (h, i)),
                ins=[ptg.In(data=lambda g, h, i, j: (g.Qc, (h, i)))]),
            ptg.FlowSpec(
                "K", ptg.READ,
                tile=lambda g, h, i, j: (g.Kc, (h, j)),
                ins=[ptg.In(data=lambda g, h, i, j: (g.Kc, (h, j)))]),
            ptg.FlowSpec(
                "V", ptg.READ,
                tile=lambda g, h, i, j: (g.Vc, (h, j)),
                ins=[ptg.In(data=lambda g, h, i, j: (g.Vc, (h, j)))]),
            ptg.FlowSpec(
                "S", ptg.RW,
                ins=[ptg.In(new=_init_state,
                            guard=lambda g, h, i, j: j == 0),
                     ptg.In(src=("ATT", lambda g, h, i, j: (h, i, j - 1),
                                 "S"),
                            guard=lambda g, h, i, j: j > 0)],
                outs=[ptg.Out(dst=("ATT", lambda g, h, i, j: (h, i, j + 1),
                                   "S"),
                              guard=lambda g, h, i, j: j < g.T - 1),
                      ptg.Out(dst=("NORM", lambda g, h, i, j: (h, i), "S"),
                              guard=lambda g, h, i, j: j == g.T - 1)]),
        ])

    NORM = tp.task_class(
        "NORM", params=("h", "i"),
        space=lambda g: ((h, i) for h in range(g.H) for i in range(g.T)),
        affinity=lambda g, h, i: (g.Qc, (h, i)),
        flows=[
            ptg.FlowSpec(
                "S", ptg.READ,
                ins=[ptg.In(src=("ATT", lambda g, h, i: (h, i, g.T - 1),
                                 "S"))]),
            ptg.FlowSpec(
                "O", ptg.WRITE,
                outs=[ptg.Out(dst=("GATH", lambda g, h, i: (i, h), "Hd"))]),
        ])

    GATH = tp.task_class(
        "GATH", params=("i", "h"),
        space=lambda g: ((i, h) for i in range(g.T) for h in range(g.H)),
        affinity=lambda g, i, h: (g.Qc, (0, i)),
        flows=[
            ptg.FlowSpec(
                "Hd", ptg.READ,
                ins=[ptg.In(src=("NORM", lambda g, i, h: (h, i), "O"))]),
            ptg.FlowSpec(
                "C", ptg.RW,
                ins=[ptg.In(new=lambda g, i, h: None,
                            guard=lambda g, i, h: h == 0),
                     ptg.In(src=("GATH", lambda g, i, h: (i, h - 1), "C"),
                            guard=lambda g, i, h: h > 0)],
                outs=[ptg.Out(dst=("GATH", lambda g, i, h: (i, h + 1), "C"),
                              guard=lambda g, i, h: h < g.H - 1),
                      ptg.Out(dst=("FFN", lambda g, i, h: (i,), "X"),
                              guard=lambda g, i, h: h == g.H - 1)]),
        ])

    FFN = tp.task_class(
        "FFN", params=("i",),
        space=lambda g: ((i,) for i in range(g.T)),
        affinity=lambda g, i: (g.Qc, (0, i)),
        flows=[
            ptg.FlowSpec(
                "X", ptg.RW,
                ins=[ptg.In(src=("GATH", lambda g, i: (i, g.H - 1), "C"))],
                outs=[ptg.Out(data=lambda g, i: (g.Y, (i,)))]),
        ])

    # CUDA incarnation first: chore_for(CUDA) picks it on a CUDA device,
    # the CPU device falls through to the generic body below (the
    # reference per-device BODY selection, jdf2c.c GPU hook). The flash
    # kernel computes this tile pair's partial attention; the result is
    # merged into the carried online-softmax state via the (o, lse)
    # identity, so CUDA- and CPU-executed links of one chain interoperate
    # on the same state representation.
    @ATT.body_cuda
    def att_body_cuda(task, Q, K, V, S):
        acc, m, l = S
        o_j, lse_j = flash_attention(
            Q[:, None, :], K[:, None, :], V[:, None, :],
            scale=scale, return_lse=True)
        l_c = torch.clamp(l, min=1e-30)
        o_c = acc / l_c[:, None]
        lse_c = m + torch.log(l_c)
        o_m, lse_m = merge_attention_states(
            o_c, lse_c, o_j[:, 0].float(), lse_j[:, 0])
        # back to the chain's (acc, m, l) invariants with m := lse and
        # l := 1 (acc = o·l); any later fold or NORM stays consistent
        return {"S": (o_m, lse_m, torch.ones_like(lse_m))}

    @ATT.body
    def att_body(task, Q, K, V, S):
        acc, m, l = S
        s = torch.matmul(Q.float(), K.float().T) * scale
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[:, None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[:, None] + torch.matmul(p, V.float())
        return {"S": (acc_new, m_new, l_new)}

    @NORM.body
    def norm_body(task, S, O):
        acc, m, l = S
        return {"O": acc / l[:, None]}

    @GATH.body
    def gath_body(task, Hd, C):
        return {"C": Hd if C is None else torch.cat([C, Hd], dim=-1)}

    @FFN.body
    def ffn_body(task, X):
        # products outside any kernel stay torch.matmul (the reference
        # leaves them to XLA); the precision knob picks TF32 or FP32
        apply_matmul_precision()
        a = torch.matmul(X, Wo)
        hdn = torch.relu(torch.matmul(a, W1))
        return {"X": a + torch.matmul(hdn, W2)}

    return tp


def reference_block(q, k, v, Wo, W1, W2, chunk: Optional[int] = None):
    """Dense torch reference: per-head softmax attention → concat →
    output proj → FFN with residual, in f32 on the inputs' device.
    q/k/v: ``(H, S, dh)`` tensors. ``chunk`` bounds the query rows whose
    score matrix is held at once (all rows when None)."""
    apply_matmul_precision()
    H, S, dh = q.shape
    chunk = chunk or S
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((S, H * dh), dtype=torch.float32, device=q.device)
    for h in range(H):
        kh, vh = k[h].float(), v[h].float()
        for r0 in range(0, S, chunk):
            s = torch.matmul(q[h, r0:r0 + chunk].float(), kh.T) * scale
            p = torch.softmax(s, dim=-1)
            out[r0:r0 + chunk, h * dh:(h + 1) * dh] = torch.matmul(p, vh)
    a = torch.matmul(out, Wo)
    return a + torch.matmul(torch.relu(torch.matmul(a, W1)), W2)


def params_from_reference(Wo, W1, W2, *, device):
    """The reference test's numpy weights as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(w, np.float32)).to(device)
                 for w in (Wo, W1, W2))


def tiles_from_reference(q, k, v, tile_s: int, *, device):
    """Split the reference test's numpy ``q/k/v`` ``(H, S, dh)`` into
    ``(tile_s, dh)`` tiles keyed ``(h, i)`` (``tests/test_transformer.py``
    layout) and return ``(Qc, Kc, Vc)`` LocalCollections of f32 tensors on
    ``device``."""
    H, S, _ = q.shape
    T = S // tile_s
    cols = []
    for name, x in (("Q", q), ("K", k), ("V", v)):
        x = torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(device)
        cols.append(LocalCollection(name, {
            (h, i): x[h, i * tile_s:(i + 1) * tile_s]
            for h in range(H) for i in range(T)}))
    return tuple(cols)
