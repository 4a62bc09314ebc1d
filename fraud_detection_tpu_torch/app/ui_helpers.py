"""Pure presentation helpers for the UI layer, no streamlit dependency —
twin of ``fraud_detection_tpu/app/ui_helpers.py``: CSS injection, the HTML
verdict badge and the message card, kept import-safe and unit-testable. The
Streamlit apps (ui.py, chat.py) are thin shells over these functions;
streamlit is optional (absent on the GPU machine).
"""

from __future__ import annotations

import html
import importlib.resources as resources
from typing import Dict, Optional, Sequence

BADGE_COLORS = {1: "#d9534f", 0: "#3fb950"}  # scam red / normal green


def load_app_css() -> str:
    """The packaged dark theme (public/main.css equivalent)."""
    return resources.files("fraud_detection_tpu_torch.app").joinpath(
        "assets/main.css").read_text()


def styled_badge(prediction: int, label: str) -> str:
    """Pill badge for a classification verdict."""
    color = BADGE_COLORS.get(int(prediction), "#8b949e")
    return (f'<span class="fraud-badge" style="background:{color}">'
            f"{html.escape(label)}</span>")


def confidence_text(confidence: float) -> str:
    return f"{confidence:.1%}"


def message_card(result: Dict) -> str:
    """HTML card for one classified streaming message (tab-3 feed)."""
    pred = result.get("prediction")
    label = result.get("label", "?")
    conf = result.get("confidence")
    text = result.get("original_text") or result.get("original") or ""
    badge = styled_badge(pred if pred is not None else -1,
                         label if pred is not None else "error")
    conf_part = f' <span class="card-conf">{confidence_text(conf)}</span>' if conf is not None else ""
    body = html.escape(text if len(text) <= 240 else text[:240] + "…")
    analysis = result.get("analysis")
    analysis_part = (f'<div class="card-analysis">{html.escape(analysis)}</div>'
                     if analysis else "")
    return (f'<div class="kafka-card">{badge}{conf_part}'
            f'<div class="card-text">{body}</div>{analysis_part}</div>')


def batch_result_rows(texts: Sequence[str], predictions, probabilities) -> list:
    """Rows for the batch tab's result table / downloadable CSV."""
    rows = []
    for text, pred, prob in zip(texts, predictions, probabilities):
        conf = float(prob) if int(pred) == 1 else 1.0 - float(prob)
        rows.append({
            "dialogue": text,
            "prediction": int(pred),
            "label": "Potential Scam" if int(pred) == 1 else "Normal Conversation",
            "confidence": round(conf, 6),
        })
    return rows


def require_streamlit():
    """Import streamlit or explain how to get the UI running."""
    try:
        import streamlit  # noqa: F401

        return streamlit
    except ImportError as exc:  # pragma: no cover - env without streamlit
        raise SystemExit(
            "The UI needs streamlit (`pip install streamlit`), which is not "
            "part of the core framework dependencies. Headless equivalents: "
            "`python -m fraud_detection_tpu_torch.app.train` and "
            "`python -m fraud_detection_tpu_torch.app.serve`.") from exc
