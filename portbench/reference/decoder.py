"""A plain decoder forward in float32, the reference that served tokens are
judged against.

The architecture of both configurations (``blocks.py``): RMSNorm before
attention and before the gated MLP (SiLU), rotary embeddings on interleaved
pairs, causal attention with grouped K/V heads, no biases, an untied head.
It imports nothing of the program: the weights are drawn again from the
run's seed (``weights.draw_group``), one layer at a time, and every product
runs in float32 with TF32 off.

``precision`` sets how the weights and products are taken:

- ``"f32"``: the configuration's weights as drawn, widened to float32;
- ``"fp8"``: the control one step below bfloat16: every matrix product's
  two inputs rounded to float8 e4m3 with one scale per weight matrix and
  one per activation row (absmax over 448), then multiplied in float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from reference.blocks import fp32_exact, layer, plain_mm, rms_norm
from weights import draw_group

E4M3_MAX = 448.0
PRECISIONS = ("f32", "fp8")


def to_e4m3(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under an absmax scale (one scale for the
    tensor, or one along ``dim``), returned in f32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim,
                                                           keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product whose activation rows are rounded to e4m3 (``w`` already
    is)."""
    return plain_mm(to_e4m3(x, dim=-1), w)


def weights_at(w: torch.Tensor, name: str, precision: str) -> torch.Tensor:
    """One drawn matrix as the reference at ``precision`` multiplies by it
    (a norm gain is not a matrix and stays as drawn)."""
    if precision == "fp8" and name != "embed" and w.dim() > 1:
        return to_e4m3(w.float())
    return w.float()


class Decoder:
    """Logits of whole sequences, layer by layer over all of them at once."""

    def __init__(self, cfg: Dict, seed: int, device, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.seed, self.device = cfg, seed, device
        self.precision = precision
        self.mm = fp8_mm if precision == "fp8" else plain_mm

    def _weights(self, group: str) -> Dict[str, torch.Tensor]:
        drawn = draw_group(self.cfg, self.seed, group, self.device)
        return {n: weights_at(w, n, self.precision) for n, w in drawn.items()}

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               positions: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (T,), the f32 logits (len(pos), V) at its
        ``positions``."""
        fp32_exact()
        gains = self._weights("norms")
        embed = self._weights("embed")["embed"]
        xs = [embed[s.to(self.device).long()][None] for s in seqs]
        del embed
        for i in range(self.cfg["num_hidden_layers"]):
            w = self._weights(f"l{i}")
            w.update(ln1=gains[f"l{i}.ln1"], ln2=gains[f"l{i}.ln2"])
            xs = [layer(x, w, self.cfg, self.mm) for x in xs]
            del w
        group = "embed" if self.cfg["tie_word_embeddings"] else "lm_head"
        head = self._weights(group)[group]
        out = []
        for x, pos in zip(xs, positions):
            h = rms_norm(x[0, pos.to(self.device).long()],
                         self.cfg["rms_norm_eps"], gains["ln_f"])
            out.append(self.mm(h, head.T))
        return out


def token_gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position, how far the chosen token's logit lies below the best
    one: max(logits) - logits[chosen] (0 where it is the best)."""
    chosen = chosen.to(logits.device).long()
    return logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]
