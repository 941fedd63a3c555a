"""PCHIP (monotone cubic Hermite) interpolation, batch-last.

Port of `apex_tpu/utils/pchip.py`: the Fritsch-Carlson derivative rule of
scipy's `pchip` plus cubic Hermite evaluation. The reward clocks of the
Cassie env carry per-env knots, so here the knot vector is batched too:
x (n, B), y (k, n, B), d (k, n, B), t (B,).
"""
from __future__ import annotations

import torch


def pchip_derivatives(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Knot derivatives. x: (n, B) strictly increasing along n; y: (k, n, B).
    Interior: weighted harmonic mean of adjacent secants, zero when secants
    change sign or vanish. Ends: one-sided three-point rule with
    monotonicity clamping (scipy's `_edge_case`)."""
    h = x[1:] - x[:-1]                           # (n-1, B)
    m = (y[:, 1:] - y[:, :-1]) / h               # (k, n-1, B)

    hk, hk1 = h[:-1], h[1:]
    mk, mk1 = m[:, :-1], m[:, 1:]
    w1 = 2 * hk1 + hk
    w2 = hk1 + 2 * hk
    whmean = (w1 / mk + w2 / mk1) / (w1 + w2)
    interior = torch.where((torch.sign(mk) * torch.sign(mk1)) > 0,
                           1.0 / whmean, 0.0)

    def edge(h0, h1, m0, m1):
        d = ((2 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
        d = torch.where(torch.sign(d) != torch.sign(m0), 0.0, d)
        return torch.where(
            (torch.sign(m0) != torch.sign(m1)) & (torch.abs(d) > 3 * torch.abs(m0)),
            3 * m0, d)

    d0 = edge(h[0], h[1], m[:, 0], m[:, 1])
    dn = edge(h[-1], h[-2], m[:, -1], m[:, -2])
    return torch.cat([d0[:, None], interior, dn[:, None]], dim=1)


def pchip_eval(x: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Evaluate the Hermite cubics (x, y, d) at t (B,) -> (k, B), clamped to
    the knot span."""
    n = x.shape[0]
    t = torch.minimum(torch.maximum(t, x[0]), x[-1])
    # searchsorted(x, t, side="right") - 1 == (number of knots <= t) - 1
    idx = torch.clamp(torch.sum(x <= t[None], dim=0) - 1, 0, n - 2)[None]
    x0 = torch.gather(x, 0, idx)[0]
    h = torch.gather(x, 0, idx + 1)[0] - x0
    s = (t - x0) / h
    yi = idx[None].expand(y.shape[0], 1, -1)
    y0, y1 = torch.gather(y, 1, yi)[:, 0], torch.gather(y, 1, yi + 1)[:, 0]
    d0, d1 = torch.gather(d, 1, yi)[:, 0], torch.gather(d, 1, yi + 1)[:, 0]
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return h00 * y0 + h10 * h * d0 + h01 * y1 + h11 * h * d1
