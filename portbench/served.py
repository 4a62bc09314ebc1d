"""The check of a served model: the greedy tokens the timed path served,
judged against the plain reference's logits over the same prompts.

At each served position the gap is how far the served token's reference
logit lies below the reference's best; a request's number is its widest
gap, and a run's the widest over its sample. The control puts the
reference in a lower precision in the program's place and reads, at the
same positions, the gap of the token that precision puts first.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.decoder import Decoder, token_gaps

Served = Tuple[np.ndarray, np.ndarray]     # (prompt tokens, served tokens)


def sample(finished: Sequence[Served], seed: int, min_tokens: int,
           max_requests: int) -> List[Served]:
    """The longest finished request, then others drawn from the seed until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -len(finished[i][1]))
    picked = [order[0]]
    rest = order[1:]
    random.Random(seed).shuffle(rest)
    total = len(finished[order[0]][1])
    for i in rest:
        if total >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(i)
        total += len(finished[i][1])
    return [finished[i] for i in picked]


def _inputs(items: Sequence[Served]):
    seqs, pos = [], []
    for prompt, out in items:
        seqs.append(torch.from_numpy(np.concatenate(
            [prompt, out[:-1]]).astype(np.int64)))
        pos.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out)))
    return seqs, pos


def gaps(cfg: Dict, seed: int, device, items: Sequence[Served],
         control: Optional[str] = None) -> Dict:
    """``{"gap": widest gap of the served tokens, "per_request": [...],
    "control_gap": widest gap of the control's first choices}`` (the last
    only with ``control``)."""
    seqs, pos = _inputs(items)
    ref = Decoder(cfg, seed, device).logits(seqs, pos)
    per = [float(token_gaps(r, torch.from_numpy(out.astype(np.int64))).max())
           for r, (_, out) in zip(ref, items)]
    result = {"gap": max(per) if per else 0.0, "per_request": per,
              "tokens": int(sum(len(o) for _, o in items))}
    if control is not None:
        low = Decoder(cfg, seed, device, control).logits(seqs, pos)
        ctrl = [float(token_gaps(r, c.argmax(dim=-1)).max())
                for r, c in zip(ref, low)]
        result["control_gap"] = max(ctrl) if ctrl else 0.0
        result["control_per_request"] = ctrl
    return result
