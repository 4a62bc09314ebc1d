"""Synthetic scam/legit phone-dialogue corpus generator.

The reference trains on the BothBosu ``agent_conversation_all.csv`` (1,600
synthetic agent/customer dialogues, balanced 800/800 — SURVEY.md §6), streamed
from HuggingFace at train time (fraud_detection_spark.py:331). That network
fetch is unavailable here, so this module generates a corpus with the same
shape and statistical character: multi-turn Agent/Customer transcripts,
balanced labels, scam dialogues drawn from the classic phone-scam families
(SSA/IRS impersonation, prize/sweepstakes, tech support, bank fraud, gift
cards) and legitimate dialogues from routine call types (appointments,
deliveries, support, surveys). Fully seeded — the same seed always yields the
same corpus, which keeps trainer tests and benchmarks deterministic.

Difficulty is a first-class knob. The reference's published metrics are
discriminative (DT 0.9834 < RF/XGB 0.9934 test accuracy, report-paper.pdf
Table II) because the real BothBosu classes share vocabulary; a corpus where
"gift card" only ever appears in scams is trivially separable and every model
scores 1.0. Three mechanisms close that gap, all on by default:

- **hard variants** (``hard_fraction``): legitimate calls that use scam
  vocabulary (a bank's *real* fraud-alert call, a past-due utility reminder,
  a survey whose incentive is a gift card) and scams that avoid it (refund
  scams, family-emergency scams, appointment-pretext pivots, investment
  pitches) — so no single token separates the classes;
- **paraphrase overlap**: neutral filler turns ("Can you hear me okay?",
  "Let me pull up your information") injected into both classes;
- **label noise** (``label_noise``): a seeded fraction of labels flipped,
  modelling the annotation noise every real corpus carries.

Transport/plumbing tests that need separable data pass
``hard_fraction=0.0, label_noise=0.0`` explicitly; demos and benches keep the
hard defaults (a demo stream whose ground-truth labels carry ~2% noise is the
realistic regime).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Sequence, Tuple

SCAM_OPENERS = [
    "Hello, this is {name} calling from the {org}. This is an urgent matter regarding your {subject}.",
    "Good afternoon, my name is {name} with the {org}. We have detected suspicious activity on your {subject}.",
    "This is {name} from the {org}. I am calling about a serious problem with your {subject}.",
    "Congratulations! This is {name} from the {org}. You have been selected as a winner in our {subject} promotion.",
]
SCAM_ORGS = [
    "Social Security Administration", "Internal Revenue Service", "Federal Reserve",
    "Microsoft Technical Support", "National Prize Center", "Bank Security Department",
    "Amazon Fraud Prevention", "Medicare Services",
]
SCAM_SUBJECTS = [
    "social security number", "tax account", "bank account", "computer",
    "sweepstakes entry", "credit card", "benefits account", "online account",
]
SCAM_DEMANDS = [
    "You must verify your {subject} immediately or it will be suspended.",
    "A warrant will be issued for your arrest unless you act right now.",
    "You need to pay a processing fee of {amount} dollars with gift cards today.",
    "Please purchase {amount} dollars in gift cards and read me the codes to secure your funds.",
    "We need you to confirm your full account number and password to stop the fraudulent charges.",
    "Your funds must be transferred to a safe government account immediately.",
    "If you hang up, legal action will begin against you within the hour.",
    "To claim your prize you must send the registration fee by wire transfer urgently.",
]
SCAM_PRESSURE = [
    "This is extremely urgent and confidential. Do not tell anyone at your bank.",
    "Officers are on their way unless we resolve this immediately.",
    "This offer expires in thirty minutes, you must decide now.",
    "Your account will be frozen permanently if you do not cooperate.",
    "Stay on the line, do not hang up under any circumstances.",
]
CUSTOMER_WARY = [
    "This sounds suspicious to me. How do I know you are real?",
    "I was not expecting any call like this. Are you sure?",
    "I do not feel comfortable giving that information over the phone.",
    "Why would the government ask for gift cards?",
    "Let me call the official number and check first.",
]
CUSTOMER_COMPLIANT = [
    "Oh no, that sounds serious. What do I need to do?",
    "I understand. Which card numbers do you need?",
    "Please help me fix this, I do not want any trouble.",
    "Okay, I am writing down the instructions now.",
]

LEGIT_OPENERS = [
    "Good morning, this is {name} from {org}. I am calling to {purpose}.",
    "Hi, you have reached {org}, {name} speaking. How can I help you today?",
    "Hello, this is {name} at {org}, following up to {purpose}.",
]
LEGIT_ORGS = [
    "the dental clinic", "city library", "the auto repair shop", "your internet provider",
    "the veterinary office", "the pharmacy", "the school office", "the electric company",
    "the hotel front desk", "the airline reservations desk",
]
LEGIT_PURPOSES = [
    "confirm your appointment for tomorrow afternoon",
    "let you know your order is ready for pickup",
    "remind you about your scheduled service visit",
    "follow up on the request you submitted last week",
    "check whether the technician visit resolved your issue",
    "confirm the reservation details for your stay",
]
LEGIT_BODY = [
    "Agent: We have you down for {time}. Does that still work for you?\nCustomer: Yes, that works fine for me.\nAgent: Wonderful. Please remember to bring your {item}.",
    "Customer: Thanks for letting me know. Can I come by around {time}?\nAgent: Of course, we are open until six. See you then.",
    "Agent: Is there anything else I can help you with today?\nCustomer: No, that covers everything. Thank you so much for the call.",
    "Customer: Actually, could we reschedule to {time}?\nAgent: No problem at all, I have moved it. You will get a confirmation message shortly.",
    "Agent: The total came to {amount} dollars and your warranty covers most of it.\nCustomer: That is great news, thank you for the update.",
]
LEGIT_CLOSERS = [
    "Agent: Thank you for your time. Have a wonderful day.\nCustomer: You too, goodbye.",
    "Agent: We appreciate your business. Take care.\nCustomer: Thanks, bye.",
    "Customer: Thanks again for the reminder. Goodbye.\nAgent: Goodbye.",
]
NAMES = ["Daniels", "Morgan", "Chen", "Patel", "Garcia", "Smith", "Johnson", "Lee", "Brown", "Walker"]
TIMES = ["nine in the morning", "noon", "two thirty", "three pm", "four o'clock", "five fifteen"]
ITEMS = ["insurance card", "photo id", "order confirmation", "parking pass", "paperwork"]

# Neutral filler exchanged verbatim in BOTH classes (paraphrase overlap): these
# turns carry tokens but zero label signal, diluting per-token informativeness.
NEUTRAL_FILLER = [
    "Agent: Can you hear me okay? The line was breaking up for a moment.\nCustomer: Yes, I can hear you now, go ahead.",
    "Agent: Let me pull up your information, one moment please.\nCustomer: Sure, take your time.",
    "Customer: Sorry, could you repeat that? I did not catch the last part.\nAgent: Of course, let me say that again more slowly.",
    "Agent: Just to make sure I have the right person, am I speaking with the account holder?\nCustomer: Yes, speaking.",
    "Customer: Hold on, let me grab a pen to write this down.\nAgent: No problem, I will wait.",
    "Agent: Thank you for your patience while I check on that.\nCustomer: That is fine.",
]

# ---------------------------------------------------------------------------
# Hard legitimate calls: routine business that *shares scam vocabulary* —
# a real bank fraud alert says "suspicious activity" and "verify", a survey's
# incentive is a "gift card", a utility reminder says "service interruption".
# No depth-5 token test separates these from the scam families alone.
# ---------------------------------------------------------------------------
BANKS = ["First National Bank", "the credit union", "Community Savings Bank",
         "your card issuer", "Harbor Trust Bank"]

def _hard_legit_fraud_alert(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    bank = rng.choice(BANKS)
    lines = [
        f"Agent: Hello, this is {fmt['name']} calling from the fraud prevention team at {bank}. We detected suspicious activity on your card ending in {rng.randint(1000, 9999)}.",
        "Customer: " + rng.choice(CUSTOMER_WARY + ["Oh? What kind of activity?"]),
        f"Agent: There was a charge of {rng.choice([89, 240, 310, 560])} dollars that looked unusual for your account. Did you authorize that purchase?",
        "Customer: " + rng.choice(["No, that was not me.", "Hmm, actually yes, that was my purchase.",
                                   "I am not sure, let me think about it."]),
        "Agent: Understood. For your security we will block the card and mail a replacement. We will never ask for your PIN or full card number on this call.",
        "Customer: Okay, thank you for catching that so quickly.",
    ]
    return f"legit:fraud-alert:{bank}", lines

def _hard_legit_utility(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Good morning, this is {fmt['name']} with the electric company with a courtesy reminder about your past due balance of {rng.choice([40, 65, 95, 130])} dollars.",
        "Customer: Oh, I thought I had paid that already.",
        "Agent: To avoid any interruption of service, you can pay online, by mail, or at our office. There is no need to provide payment information over the phone.",
        "Customer: " + rng.choice(["Alright, I will pay on the website tonight.",
                                   "Can I get an extension until Friday?"]),
        "Agent: That works. Your account will show the update within one business day.",
    ]
    return "legit:utility-pastdue", lines

def _hard_legit_pharmacy(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hello, this is {fmt['name']} from the pharmacy. Before I share any details I need to verify your identity. Can you confirm your date of birth?",
        "Customer: " + rng.choice(["Sure, it is on file with you already.",
                                   "Why do you need that?",
                                   "Okay, one moment."]),
        "Agent: Thank you, that matches our records. Your prescription is ready for pickup, and your insurance covered most of the cost.",
        f"Customer: Great, I will stop by around {rng.choice(TIMES)}.",
        "Agent: See you then. Please bring your photo id.",
    ]
    return "legit:pharmacy-verify", lines

def _hard_legit_survey(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hi, this is {fmt['name']} from the customer research team. We are running a short satisfaction survey about your recent visit.",
        "Customer: " + rng.choice(["How long will it take?", "Okay, I have a few minutes."]),
        f"Agent: Just five questions. As a thank you, completing the survey enters you into a drawing for a {rng.choice([25, 50, 100])} dollar gift card.",
        "Customer: " + rng.choice(["Sounds fine, go ahead.", "Alright, let us do it quickly."]),
        "Agent: Wonderful. First question, how would you rate the service you received?",
        "Customer: I would say very good overall, maybe four out of five.",
    ]
    return "legit:survey-incentive", lines

def _hard_legit_security_followup(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hello, this is {fmt['name']} from your internet provider's security team, following up on the password reset you requested this morning.",
        "Customer: Yes, I did request that.",
        "Agent: Great. The reset link was sent to the email on file. We will never ask you to read us your password or any verification codes.",
        "Customer: " + rng.choice(["Good to know, I found the email.",
                                   "Understood, thanks for confirming it was really you."]),
        "Agent: Is there anything else I can help you with regarding your account security?",
        "Customer: No, that covers it. Thanks for the follow up.",
    ]
    return "legit:security-followup", lines

HARD_LEGIT = [_hard_legit_fraud_alert, _hard_legit_utility, _hard_legit_pharmacy,
              _hard_legit_survey, _hard_legit_security_followup]

# ---------------------------------------------------------------------------
# Soft scams: fraud that *avoids* the loud scam markers — calm refund scams,
# family-emergency appeals, appointment-pretext pivots, investment pitches.
# Their surface register is the legitimate one; only the ask gives them away.
# ---------------------------------------------------------------------------
def _soft_scam_refund(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hello, this is {fmt['name']} from the billing department. Good news, we owe you a refund of {rng.choice([120, 250, 399])} dollars from an accidental double charge.",
        "Customer: " + rng.choice(["Oh, I did not notice a double charge.", "A refund? That is a surprise."]),
        "Agent: It happens with automatic renewals. To process the refund today I just need to confirm the card number the charge came from.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
        "Agent: I understand completely. It only takes a minute, and the refund goes straight back to the same card once you read me the number.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
    ]
    return "scam:refund", lines

def _soft_scam_family(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        "Agent: " + rng.choice(["Grandma? It is me. I am in trouble and I did not know who else to call.",
                                "Hey, it is your grandson. Something happened on my trip, please do not tell mom."]),
        "Customer: " + rng.choice(["Oh dear, what happened? Are you okay?",
                                   "You sound different. Is everything alright?"]),
        f"Agent: There was an accident and I need {rng.choice([800, 1200, 2500])} dollars for the lawyer today. Can you send it by wire or a money app? Please keep this between us.",
        "Customer: " + rng.choice(["Of course sweetheart, tell me where to send it.",
                                   "Let me call your mother first to check.",
                                   "Why can you not call your parents about this?"]),
        "Agent: There is no time, the hearing is this afternoon. Please, I am begging you, and do not tell anyone.",
    ]
    return "scam:family-emergency", lines

def _soft_scam_pivot(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Good morning, this is {fmt['name']} from {rng.choice(LEGIT_ORGS)}, calling to {rng.choice(LEGIT_PURPOSES)}.",
        "Customer: " + rng.choice(["Hi, thanks for calling.", "Oh good, I was hoping to hear from you."]),
        f"Agent: We have you down for {rng.choice(TIMES)}. Before I can finalize it, our new system needs me to confirm the social security number and the card you will pay with.",
        "Customer: " + rng.choice(CUSTOMER_WARY + ["You never needed that before for an appointment."]),
        "Agent: It is just the new policy, everyone has to do it. I can hold while you find the card.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
    ]
    return "scam:appointment-pivot", lines

def _soft_scam_investment(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hello, this is {fmt['name']} with a private investor group. A mutual contact suggested you might want to hear about an opportunity with guaranteed returns.",
        "Customer: " + rng.choice(["What kind of opportunity?", "I do not usually take these calls."]),
        f"Agent: Our members are doubling their savings in about thirty days. The minimum to join is only {rng.choice([500, 1000, 2000])} dollars and spots close this week.",
        "Customer: " + rng.choice(["Doubling in a month sounds too good to be true.",
                                   "How would I even get started?"]),
        "Agent: I can reserve your spot right now if you move the deposit today. People who wait usually miss out.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
    ]
    return "scam:investment", lines

def _soft_scam_renewal(rng: random.Random, fmt: dict) -> Tuple[str, List[str]]:
    lines = [
        f"Agent: Hello, this is {fmt['name']} from the subscription services desk. Your plan renews automatically today for {rng.choice([299, 399, 499])} dollars unless you cancel.",
        "Customer: " + rng.choice(["I do not remember signing up for anything.",
                                   "That is a lot of money. Which subscription?"]),
        "Agent: It was part of a trial from last year. I can process the cancellation and refund right now, I just need the card on the account to reverse the charge.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
        "Agent: If we do not cancel before the cutoff the renewal goes through, so it is best to take care of it on this call.",
        "Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT),
    ]
    return "scam:renewal", lines

SOFT_SCAM = [_soft_scam_refund, _soft_scam_family, _soft_scam_pivot,
             _soft_scam_investment, _soft_scam_renewal]


@dataclass
class Dialogue:
    text: str
    label: int  # 1 = scam
    kind: str


def _maybe_filler(rng: random.Random, lines: List[str], p: float = 0.5) -> None:
    """Insert a neutral filler exchange at a random interior position."""
    if rng.random() < p:
        lines.insert(rng.randint(1, max(1, len(lines) - 1)), rng.choice(NEUTRAL_FILLER))


def _gen_scam(rng: random.Random, hard_fraction: float = 0.0) -> Dialogue:
    org = rng.choice(SCAM_ORGS)
    subject = rng.choice(SCAM_SUBJECTS)
    fmt = dict(name=rng.choice(NAMES), org=org, subject=subject,
               amount=str(rng.choice([200, 500, 900, 1500, 2000])))
    if rng.random() < hard_fraction:
        kind, lines = rng.choice(SOFT_SCAM)(rng, fmt)
        _maybe_filler(rng, lines)
        return Dialogue(text="\n".join(lines), label=1, kind=kind)
    lines = ["Agent: " + rng.choice(SCAM_OPENERS).format(**fmt)]
    lines.append("Customer: " + rng.choice(["Who is this? What is this about?",
                                            "Oh? I was not expecting a call.",
                                            "Yes, this is me speaking."]))
    for _ in range(rng.randint(2, 4)):
        lines.append("Agent: " + rng.choice(SCAM_DEMANDS).format(**fmt))
        lines.append("Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT))
    lines.append("Agent: " + rng.choice(SCAM_PRESSURE))
    lines.append("Customer: " + rng.choice(CUSTOMER_WARY + CUSTOMER_COMPLIANT))
    _maybe_filler(rng, lines, p=0.35 if hard_fraction else 0.0)
    return Dialogue(text="\n".join(lines), label=1, kind=f"scam:{org}")


def _gen_legit(rng: random.Random, hard_fraction: float = 0.0) -> Dialogue:
    fmt = dict(name=rng.choice(NAMES), org=rng.choice(LEGIT_ORGS),
               purpose=rng.choice(LEGIT_PURPOSES), time=rng.choice(TIMES),
               item=rng.choice(ITEMS), amount=str(rng.choice([20, 45, 80, 120])))
    if rng.random() < hard_fraction:
        kind, lines = rng.choice(HARD_LEGIT)(rng, fmt)
        _maybe_filler(rng, lines)
        return Dialogue(text="\n".join(lines), label=0, kind=kind)
    lines = ["Agent: " + rng.choice(LEGIT_OPENERS).format(**fmt)]
    lines.append("Customer: " + rng.choice(["Hi, thanks for calling.",
                                            "Oh good, I was hoping to hear from you.",
                                            "Hello, yes this is a good time."]))
    for _ in range(rng.randint(1, 3)):
        lines.append(rng.choice(LEGIT_BODY).format(**fmt))
    lines.append(rng.choice(LEGIT_CLOSERS))
    _maybe_filler(rng, lines, p=0.35 if hard_fraction else 0.0)
    return Dialogue(text="\n".join(lines), label=0, kind="legit")


def generate_corpus(n: int = 1600, seed: int = 42, scam_fraction: float = 0.5,
                    *, hard_fraction: float = 0.45,
                    label_noise: float = 0.02) -> List[Dialogue]:
    """Balanced synthetic corpus; same arguments always yield the same data.

    ``hard_fraction`` — probability each dialogue is drawn from the
    vocabulary-overlapping hard families (see module docstring);
    ``label_noise`` — seeded fraction of labels flipped after generation
    (flipped items get ``+flipped`` appended to their kind). Defaults make the
    corpus discriminative: published-reference-like test metrics below 1.0
    with DT under RF/XGB. Pass ``hard_fraction=0.0, label_noise=0.0`` for the
    separable corpus that transport tests train and score against.
    """
    rng = random.Random(seed)
    n_scam = int(round(n * scam_fraction))
    out = [_gen_scam(rng, hard_fraction) for _ in range(n_scam)]
    out += [_gen_legit(rng, hard_fraction) for _ in range(n - n_scam)]
    rng.shuffle(out)
    if label_noise > 0.0:
        # Exactly round(n * label_noise) seeded flips — an independent
        # per-item Bernoulli could realize zero flips at small n.
        for i in rng.sample(range(len(out)), int(round(len(out) * label_noise))):
            d = out[i]
            out[i] = Dialogue(text=d.text, label=1 - d.label,
                              kind=d.kind + "+flipped")
    return out


def train_val_test_split(items: Sequence, seed: int = 42,
                         fractions: Tuple[float, float, float] = (0.7, 0.1, 0.2)):
    """Seeded 70/10/20 split (reference: two chained randomSplits, seed 42 —
    fraud_detection_spark.py:338-339; exact Spark row assignment is
    sampler-internal, so this replicates the protocol, not the membership)."""
    idx = list(range(len(items)))
    random.Random(seed).shuffle(idx)
    n = len(items)
    n_train = int(round(fractions[0] * n))
    n_val = int(round(fractions[1] * n))
    pick = lambda ids: [items[i] for i in ids]
    return pick(idx[:n_train]), pick(idx[n_train:n_train + n_val]), pick(idx[n_train + n_val:])
