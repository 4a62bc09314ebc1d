"""Streamlit front end: single / batch / real-time tabs — twin of
``fraud_detection_tpu/app/ui.py`` on the port's stack:

  * one cached agent scores micro-batches on the card, and
    ``classify_and_explain`` scores once;
  * the real-time tab drains the consumer through the micro-batching engine
    on a worker thread into a thread-safe deque;
  * the LLM backend is pluggable (hosted / any OpenAI-compatible URL /
    canned offline), selected from the sidebar.

Run:  streamlit run fraud_detection_tpu_torch/app/ui.py  (or python -m
fraud_detection_tpu_torch.app.ui for the import check). Model selection via
FRAUD_MODEL_PATH (native checkpoint dir or ``spark:<dir>``) — defaults to
the synthetic demo model; ``FRAUD_DEVICE`` names the torch device (the
card, ``cuda``, unless it says ``cpu``).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

from fraud_detection_tpu_torch.app.ui_helpers import (
    batch_result_rows,
    load_app_css,
    message_card,
    require_streamlit,
    styled_badge,
)
from fraud_detection_tpu_torch.explain import (CannedBackend, FraudAnalysisAgent,
                                               OpenAIChatBackend)
from fraud_detection_tpu_torch.utils import AppConfig, get_logger

log = get_logger("app.ui")


def build_agent(config: AppConfig, backend_choice: str, base_url: str,
                temperature: float, device="cuda") -> FraudAnalysisAgent:
    """The agent behind the app: the serve CLI's pipeline for
    ``FRAUD_MODEL_PATH`` (``spark:<dir>`` included) on ``device``, and the
    sidebar's explanation backend."""
    from fraud_detection_tpu_torch.app.serve import build_pipeline

    spec = config.serving.model_path or "synthetic"
    pipeline = build_pipeline(spec, config.serving.batch_size, device=device)
    if backend_choice == "DeepSeek API" and config.llm.api_key:
        backend = config.llm.make_backend()
    elif backend_choice == "OpenAI-compatible URL":
        backend = OpenAIChatBackend(base_url=base_url, model=config.llm.model)
    else:
        backend = CannedBackend(
            responses=["(offline mode: configure DEEPSEEK_API_KEY or a local "
                       "OpenAI-compatible endpoint for live analysis)"])
    return FraudAnalysisAgent(pipeline, backend=backend, temperature=temperature)


class MonitorState:
    """Thread-safe holder for the real-time tab's engine + recent results."""

    def __init__(self, maxlen: int = 200):
        self.recent = deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.engine = None
        self.thread = None

    def on_result(self, payload: dict) -> None:
        with self.lock:
            self.recent.append(payload)

    def snapshot(self, n: int = 5) -> list:
        with self.lock:
            return list(self.recent)[-n:]


def start_monitor(state: MonitorState, agent: FraudAnalysisAgent,
                  config: AppConfig, demo: bool) -> None:
    """Start the real-time tab's engine on a daemon worker thread: demo mode
    drains 500 synthetic messages from an in-process broker, otherwise the
    Kafka input topic; every classified frame is tapped into ``state``."""
    from fraud_detection_tpu_torch.stream import InProcessBroker, StreamingClassifier

    if demo:
        broker = InProcessBroker(num_partitions=3)
        feeder = broker.producer()
        from fraud_detection_tpu_torch.data import generate_corpus

        for i, d in enumerate(generate_corpus(n=500, seed=99)):
            feeder.produce(config.kafka.input_topic,
                           json.dumps({"text": d.text}).encode(), key=str(i).encode())
        consumer = broker.consumer([config.kafka.input_topic], "ui-monitor")
        producer = broker.producer()
    else:
        from fraud_detection_tpu_torch.stream.kafka import KafkaConsumer, KafkaProducer

        consumer = KafkaConsumer([config.kafka.input_topic], config=config.kafka)
        producer = KafkaProducer(config=config.kafka)

    tap = state.on_result

    class TappedProducer:
        def __init__(self, inner):
            self.inner = inner

        def produce(self, topic, value, key=None):
            try:
                tap(json.loads(value.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                pass
            self.inner.produce(topic, value, key=key)

        def flush(self, timeout: float = 10.0):
            return self.inner.flush(timeout) if hasattr(self.inner, "flush") else 0

    state.engine = StreamingClassifier(
        agent.pipeline, consumer, TappedProducer(producer),
        config.kafka.output_topic, batch_size=config.serving.batch_size,
        max_wait=config.serving.max_wait)
    state.thread = threading.Thread(
        target=state.engine.run,
        kwargs={"idle_timeout": None if not demo else 5.0}, daemon=True)
    state.thread.start()


def main() -> None:  # pragma: no cover - drives streamlit
    st = require_streamlit()
    st.set_page_config(page_title="Fraud Detection", layout="wide")
    st.markdown(f"<style>{load_app_css()}</style>", unsafe_allow_html=True)
    config = AppConfig.from_env(dotenv_paths=[".env", "utils/.env"])

    with st.sidebar:
        st.title("Settings")
        backend_choice = st.selectbox(
            "Explanation backend",
            ["Offline (no LLM)", "DeepSeek API", "OpenAI-compatible URL"])
        base_url = st.text_input("Endpoint URL", "http://localhost:1234/v1")
        temperature = st.slider("LLM temperature", 0.0, 1.5, 1.0, 0.1)
        show_confidence = st.toggle("Show confidence", value=True)
        use_history = st.toggle("Historical comparison", value=True)
        uploaded = st.file_uploader("Historical cases CSV (dialogue,labels)", type="csv")

    @st.cache_resource
    def _agent(choice: str, url: str, temp: float) -> FraudAnalysisAgent:
        return build_agent(config, choice, url, temp,
                           device=os.getenv("FRAUD_DEVICE", "cuda"))

    agent = _agent(backend_choice, base_url, temperature)
    if uploaded is not None and agent.history is None:
        import pandas as pd

        df = pd.read_csv(uploaded)
        label_col = "labels" if "labels" in df.columns else "label"
        agent.load_history(df["dialogue"].astype(str).tolist(),
                           df[label_col].astype(int).tolist())
        st.sidebar.success(f"{len(df)} historical cases indexed")

    st.title("Phone-Scam Detection")
    tab1, tab2, tab3 = st.tabs(["Single Analysis", "Batch CSV", "Real-Time Monitor"])

    with tab1:
        text = st.text_area("Dialogue transcript", height=220)
        if st.button("Analyze") and text.strip():
            result = agent.classify_and_explain(
                text, with_history=use_history and agent.history is not None)
            st.markdown(styled_badge(result["prediction"], result["label"]),
                        unsafe_allow_html=True)
            if show_confidence:
                st.metric("Confidence", f"{result['confidence']:.1%}")
            if result.get("analysis"):
                with st.expander("LLM analysis", expanded=True):
                    st.write(result["analysis"])
            if result.get("historical_insight"):
                with st.expander("Similar historical cases"):
                    st.write(result["historical_insight"])
            if result.get("error"):
                st.warning(result["error"])

    with tab2:
        upload = st.file_uploader("CSV with a 'dialogue' column", type="csv", key="batch")
        if upload is not None and st.button("Predict Labels"):
            import pandas as pd

            df = pd.read_csv(upload)
            texts = df["dialogue"].astype(str).tolist()
            batch = agent.pipeline.predict(texts)  # one vectorized pass
            rows = batch_result_rows(texts, batch.labels, batch.probabilities)
            out = pd.DataFrame(rows)
            st.dataframe(out)
            st.download_button("Download results", out.to_csv(index=False),
                               "predictions.csv", "text/csv")

    with tab3:
        if "monitor" not in st.session_state:
            st.session_state.monitor = MonitorState()
        monitor: MonitorState = st.session_state.monitor
        demo = st.toggle("Demo mode (in-process broker + synthetic feed)",
                         value=not bool(os.getenv("KAFKA_BOOTSTRAP_SERVERS")))
        col1, col2 = st.columns(2)
        if col1.button("Start Monitoring") and monitor.engine is None:
            start_monitor(monitor, agent, config, demo)
        if col2.button("Stop") and monitor.engine is not None:
            monitor.engine.stop()
            monitor.engine = None
        if monitor.engine is not None:
            stats = monitor.engine.stats
            c1, c2, c3 = st.columns(3)
            c1.metric("Processed", stats.processed)
            c2.metric("msgs/sec", f"{stats.msgs_per_sec:.0f}")
            c3.metric("Malformed", stats.malformed)
        for payload in reversed(monitor.snapshot(5)):
            st.markdown(message_card(payload), unsafe_allow_html=True)


if __name__ == "__main__":
    main()
