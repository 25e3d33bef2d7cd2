"""Near ties: when two generations of the same function may part by rounding
alone.

Two paths that compute the same function in bf16 but sum in other orders
(a verify round over B x M rows against a decode step over B rows, the
card against the CPU, B=2 against B=1) round alike up to a relative
``2^-8`` at each rounding point, so greedy tokens may part where the top
two logits, or an output-text keep decision, lie closer than those
roundings can move them. ``plain_near_ties`` records the gaps and margins
along one path's tokens; ``explain_divergence`` judges whether a parting
point stands as such a tie.
"""

from __future__ import annotations

import numpy as np
import torch

BF16_U = 2.0**-8  # bf16 unit roundoff


def near_tie_bound(scale: float, roundings: int) -> float:
    """How close two values computed by the plain and the speculative path
    must be for their order to flip by rounding alone. Both paths compute
    the same function and round it to bf16 at the same points (each of a
    decoder layer's two residual adds, the norms, a predictor layer), but
    over B rows against B x M rows the GEMMs and K2 / K2-M sum in other
    orders, so a rounding may land on the other side: a relative difference
    of up to ``u = 2^-8`` at each of ``roundings`` points. Taken as a random
    walk, two values of magnitude ``scale`` differ by up to ``u *
    sqrt(roundings) * scale``, and a pair closer than that may swap."""
    return BF16_U * roundings**0.5 * scale


class KeepMargins:
    """Records the output-text predictor's keep margins (keep logit minus
    drop logit, and the larger magnitude of the two) of every token the
    decode paths score, by patching ``models.dynamic.text_predictor`` while
    it is entered."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from ..models import dynamic

        self.module, self.real = dynamic, dynamic.text_predictor

        def recording(p, x):
            tp = self.real(p, x)
            tp32 = tp.float()
            self.calls.append((tp32[..., 0] - tp32[..., 1], tp32.abs().amax(dim=-1)))
            return tp

        dynamic.text_predictor = recording
        return self

    def __exit__(self, *exc):
        self.module.text_predictor = self.real


def plain_near_ties(gen, plan, pix, tokens, steps):
    """The plain path's near ties along its own greedy tokens: an eager loop
    of ``decode_step`` over ``tokens`` (the graph's, which the eager loop
    reproduces bit for bit), recording before each token the top-two logit
    gap and the top logit, and each token's keep margin. Returns ``(gap
    [steps, B], top [steps, B], margins: a step's (margin [B], scale [B]) or
    None)``."""
    from ..models.dynamic import decode_step

    gaps, tops, margins = [], [], []
    with torch.inference_mode(), KeepMargins() as rec:
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        for j in range(steps):
            top2 = torch.topk(state.last_logits.float(), 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            tops.append(top2[:, 0].abs().cpu().numpy())
            tok = torch.from_numpy(np.asarray([t[j] for t in tokens])).to(gen.device)
            n = len(rec.calls)
            state = decode_step(gen.params, gen.cfg, tok, state)
            margins.append(next(((a.cpu().numpy(), s.cpu().numpy())
                                 for a, s in rec.calls[n:]), None))
    return np.stack(gaps), np.stack(tops), margins


def explain_divergence(cfg, firsts, plain, spec_margins):
    """For each sample whose speculative tokens leave plain greedy's at
    ``firsts[i]`` = j, whether that stands: plain greedy's top-two logit gap
    at j below ``near_tie_bound`` of its top logit (roundings: two a layer
    and the final norm), or the keep margin of a token before j below the
    bound of its magnitude (roundings: two a layer below the sparse layer
    and the predictor's four), on the plain path (``plain``, from
    ``plain_near_ties``) or the speculative one (``spec_margins``, the
    eager loop's). Returns ``{sample: dict(j, gap, gap_bound, margin,
    margin_bound, stands)}``."""
    gaps, tops, plain_margins = plain
    layers, sl = cfg.text.num_hidden_layers, cfg.sparse.sparse_layer
    found = {}
    for i, j in enumerate(firsts):
        if j is None:
            continue
        gap, gap_bound = float(gaps[j, i]), near_tie_bound(float(tops[j, i]), 2 * layers + 1)
        close = []  # (|margin|, bound) of the tokens before j, both paths
        for p in range(j):
            if plain_margins[p] is not None:
                a, sc = plain_margins[p]
                close.append((abs(float(a[i])), near_tie_bound(float(sc[i]), 2 * sl + 4)))
        close += [(abs(a), near_tie_bound(sc, 2 * sl + 4))
                  for p, a, sc in spec_margins[i] if p < j]
        tightest = min(close, key=lambda c: c[0] - c[1], default=(None, None))
        found[i] = dict(j=j, gap=gap, gap_bound=gap_bound, margin=tightest[0],
                        margin_bound=tightest[1],
                        stands=gap < gap_bound or any(a < bd for a, bd in close))
    return found
