"""Seeded scenario traffic — twin of ``fraud_detection_tpu/scenarios/traffic.py``,
one function of it so far: ``drift_scam_pool``, the drifted-scam texts the
learn loop is driven with (the rest of ``scenarios/`` is ROADMAP.md Queue 1
item 5). The same seed gives the JAX package's pool, text for text.
"""

from __future__ import annotations

import hashlib
from typing import List


def derive_seed(seed: int, name: str) -> int:
    """A 63-bit child seed from (seed, name), stable across processes and
    Python versions (sha256, not the randomized builtin hash) — the
    reference's ``scenarios/clock.py`` ``derive_seed``."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


_DRIFT_ASKS = [
    "Agent: While I have you, the airdrop is ready for pickup — please "
    "connect your wallet and spell out the seed phrase so I can finish "
    "the setup.\nCustomer: Okay, let me open the wallet app now.",
    "Agent: One more thing, your staking rewards are scheduled — just "
    "share the recovery words and we will move them over for you.\n"
    "Customer: Sure, the twelve words are written on my card.",
    "Agent: Also, the nft drop closes tonight — simply approve the "
    "smart contract and tell me the passphrase while we are on the "
    "line.\nCustomer: Alright, reading the passphrase now.",
    "Agent: By the way, we migrated the exchange this week — kindly "
    "sync your hardware wallet and share the recovery words with me.\n"
    "Customer: Okay, syncing the hardware wallet now.",
    "Agent: And the validator rebate is waiting — please open the "
    "wallet app and tell me the twelve seed words so I can finish it "
    "for you.\nCustomer: One moment, opening the app.",
]


def drift_scam_pool(seed: int, n: int = 64) -> List[str]:
    """Seeded drifted-scam texts (deterministic: same seed, same pool):
    legit-family transcripts with one crypto ask spliced mid-call."""
    import random as _random

    from fraud_detection_tpu_torch.data import generate_corpus

    rng = _random.Random(derive_seed(seed, "drift-pool"))
    corpus = generate_corpus(n=2 * n + 32,
                             seed=derive_seed(seed, "drift-base"),
                             hard_fraction=0.0, label_noise=0.0)
    legit = [d.text for d in corpus if d.label == 0]
    out = []
    for i in range(n):
        base = legit[rng.randrange(len(legit))]
        lines = base.split("\n")
        mid = max(1, len(lines) // 2)
        ask = _DRIFT_ASKS[rng.randrange(len(_DRIFT_ASKS))]
        out.append("\n".join(lines[:mid] + [ask] + lines[mid:]))
    return out
