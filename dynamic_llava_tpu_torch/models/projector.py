"""Multimodal projector (counterpart of ``dynamic_llava_tpu/models/projector.py``).

Params are a list of ``{"w": [in, out], "b": [out]}`` linears with EXACT
(erf) GELU between them (``mlp2x_gelu``: 1024 -> 4096 -> 4096); an empty
list is the identity projector.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def apply_projector(params: List[dict], x: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(params):
        if i > 0:
            x = F.gelu(x, approximate="none")
        x = x @ lp["w"] + lp["b"]
    return x
