"""The one traffic generator. A traffic mix is a JSON file of parameters under
``traffic/``; this module turns it and a run's seed into the requests a
driver feeds the program.

Every seed of a mix gets the same pool of sizes: the transcripts come from
a corpus drawn at the mix's own ``corpus_seed``, the output budgets from a
fixed grid in an order of the mix's own, and the run's seed draws which
transcript goes where. So runs of different seeds ask for the same work.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List


import corpus
import framing


@dataclass
class ExplainRequest:
    prompt: str          # framed, as the model receives it
    max_tokens: int
    temperature: float


def log_uniform_grid(lo: int, hi: int, n: int) -> List[int]:
    """``n`` budgets at the midpoints of n equal steps of log(lo)..log(hi),
    rounded: a log-uniform draw over [lo, hi] without the draw's noise."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (k + 0.5) * (b - a) / n))) for k in range(n)]


def stratified(values: List, strata: int, rng: random.Random) -> List:
    """``values`` in an order the seed draws, in which every run of
    ``strata`` consecutive items holds one item of each stratum (the
    sorted values cut into ``strata`` equal parts): any long enough stretch
    of the order holds the same mix of sizes, whatever the seed."""
    ordered = sorted(values)
    size = len(ordered) // strata
    parts = [ordered[j * size:(j + 1) * size] for j in range(strata)]
    for p in parts:
        rng.shuffle(p)
    out = []
    for i in range(size):
        block = [p[i] for p in parts]
        rng.shuffle(block)
        out.extend(block)
    return out


def explain_requests(mix: dict, seed: int) -> List[ExplainRequest]:
    """An analyst's batch: ``mix["requests"]`` framed analysis prompts of
    scam-labelled transcripts, output budgets log-uniform over
    [max_tokens_min, max_tokens_max], one request in each block of
    ``1 / greedy_share`` greedy and the rest sampled at ``temperature``.

    The budgets (stratified over blocks of ``strata``, ``stratified``) and
    the greedy places follow the mix's ``corpus_seed`` alone, so every run
    asks for the same work in the same order; the run's seed draws which
    transcript and confidence each request carries."""
    n = mix["requests"]
    fixed = random.Random(mix["corpus_seed"])
    budgets = stratified(log_uniform_grid(mix["max_tokens_min"],
                                          mix["max_tokens_max"], n),
                         mix["strata"], fixed)
    every = int(round(1.0 / mix["greedy_share"]))
    greedy_at = {b * every + fixed.randrange(every) for b in range(n // every)}
    rng = random.Random(seed)
    dialogues = corpus.generate_corpus(n, seed=mix["corpus_seed"],
                                       scam_fraction=1.0, label_noise=0.0)
    rng.shuffle(dialogues)
    out = []
    for i, (d, budget) in enumerate(zip(dialogues, budgets)):
        conf = rng.uniform(mix["confidence_min"], mix["confidence_max"])
        out.append(ExplainRequest(
            framing.framed(framing.analysis_prompt(d.text, 1, conf)),
            budget, 0.0 if i in greedy_at else float(mix["temperature"])))
    return out
