"""The port's front end (``fraud_detection_tpu_torch/app/ui_helpers.py``,
``ui.py``, ``chat.py``): twins of ``tests/test_ui_helpers.py`` and
``tests/test_ui_app.py``. streamlit is on neither machine, so ``main()`` of
both apps is driven headlessly through the reference tests'
``FakeStreamlit``; the app's model is a Spark artifact the port writes in
the test (``FRAUD_MODEL_PATH=spark:<dir>``), served on the CPU
(``FRAUD_DEVICE=cpu``)."""

import time

import numpy as np
import pytest

from fraud_detection_tpu_torch.app.ui import MonitorState, build_agent, start_monitor
from fraud_detection_tpu_torch.app.ui_helpers import (
    batch_result_rows,
    confidence_text,
    load_app_css,
    message_card,
    styled_badge,
)
from fraud_detection_tpu_torch.explain import (CannedBackend,
                                               FraudAnalysisAgent,
                                               OpenAIChatBackend)
from fraud_detection_tpu_torch.utils import AppConfig


def test_css_packaged():
    css = load_app_css()
    assert ".fraud-badge" in css and ".kafka-card" in css


def test_css_is_the_references():
    from fraud_detection_tpu.app.ui_helpers import load_app_css as jcss

    assert load_app_css().encode() == jcss().encode()


def test_styled_badge_escapes_and_colors():
    scam = styled_badge(1, "Potential Scam")
    ok = styled_badge(0, "Normal <&> Conversation")
    assert "#d9534f" in scam and "Potential Scam" in scam
    assert "#3fb950" in ok
    assert "<&>" not in ok and "&lt;&amp;&gt;" in ok


def test_message_card_renders_result():
    card = message_card({
        "prediction": 1, "label": "Potential Scam", "confidence": 0.987,
        "original_text": "give me your <b>SSN</b> now", "analysis": "clear scam",
    })
    assert "98.7%" in card
    assert "&lt;b&gt;SSN&lt;/b&gt;" in card
    assert "clear scam" in card
    assert "kafka-card" in card


def test_message_card_handles_malformed():
    card = message_card({"error": "malformed message", "prediction": None,
                         "original": "junk bytes"})
    assert "error" in card
    assert "junk bytes" in card


def test_message_card_truncates_long_text():
    card = message_card({"prediction": 0, "label": "Normal Conversation",
                         "confidence": 0.5, "original_text": "x" * 1000})
    assert "…" in card and "x" * 500 not in card


def test_batch_result_rows():
    rows = batch_result_rows(["a", "b"], np.asarray([1, 0]), np.asarray([0.9, 0.2]))
    assert rows[0]["label"] == "Potential Scam"
    assert rows[0]["confidence"] == 0.9
    assert rows[1]["label"] == "Normal Conversation"
    assert abs(rows[1]["confidence"] - 0.8) < 1e-9
    assert confidence_text(0.913) == "91.3%"


def test_helpers_equal_the_references():
    from fraud_detection_tpu.app import ui_helpers as j

    results = [{"prediction": 1, "label": "Potential Scam", "confidence": 0.9,
                "original_text": "a <b> " * 60, "analysis": "x & y"},
               {"error": "malformed", "prediction": None, "original": "junk"}]
    for r in results:
        assert message_card(r) == j.message_card(r)
    assert styled_badge(7, "odd") == j.styled_badge(7, "odd")
    args = (["a", "b", "c"], np.asarray([1, 0, 1]), np.asarray([0.7, 0.1, 0.55]))
    assert batch_result_rows(*args) == j.batch_result_rows(*args)


@pytest.fixture(scope="module")
def spark_lr(tmp_path_factory):
    """A HashingTF + IDF + LR Spark artifact written by the port."""
    from fraud_detection_tpu_torch.checkpoint import save_spark_pipeline
    from fraud_detection_tpu_torch.data import generate_corpus
    from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu_torch.models.train_linear import (
        fit_logistic_regression)

    docs = generate_corpus(n=300, seed=3)
    texts = [d.text for d in docs]
    feat = HashingTfIdfFeaturizer(num_features=1024)
    feat.fit_idf(texts)
    X = feat.featurize_dense(texts, device="cpu").numpy()
    model = fit_logistic_regression(X, np.asarray([d.label for d in docs],
                                                  np.float32),
                                    max_iter=30, device="cpu")
    path = tmp_path_factory.mktemp("spark") / "lr"
    save_spark_pipeline(str(path), feat, model)
    return str(path)


@pytest.fixture()
def config(monkeypatch, spark_lr):
    monkeypatch.setenv("FRAUD_MODEL_PATH", f"spark:{spark_lr}")
    monkeypatch.setenv("FRAUD_DEVICE", "cpu")
    monkeypatch.delenv("DEEPSEEK_API_KEY", raising=False)
    return AppConfig.from_env(dotenv_paths=[])


def test_build_agent_offline():
    cfg = AppConfig.from_env({"FRAUD_BATCH_SIZE": "32"})
    agent = build_agent(cfg, "Offline (no LLM)", "", temperature=0.5,
                        device="cpu")
    res = agent.classify_and_explain("agent: hello urgent prize winner claim now")
    assert "prediction" in res
    assert "offline mode" in res["analysis"]


def test_monitor_state_threadsafe_demo_run():
    """The tab-3 monitor path headless: demo broker + engine thread; every
    result's label is ``pipeline.predict``'s on its text."""
    cfg = AppConfig.from_env({"FRAUD_BATCH_SIZE": "64", "FRAUD_MAX_WAIT": "0.01"})
    agent = build_agent(cfg, "Offline (no LLM)", "", temperature=0.0,
                        device="cpu")
    state = MonitorState(maxlen=500)
    start_monitor(state, agent, cfg, demo=True)
    deadline = time.time() + 60
    while time.time() < deadline and state.engine.stats.processed < 500:
        time.sleep(0.1)
    state.engine.stop()
    state.thread.join(timeout=10)
    assert state.engine.stats.processed == 500
    snap = state.snapshot(500)
    assert len(snap) == 500
    want = agent.pipeline.predict([p["original_text"] for p in snap]).labels
    assert [p["prediction"] for p in snap] == want.tolist()


def test_build_agent_backend_selection(config):
    offline = build_agent(config, "Offline (no LLM)", "", temperature=0.7,
                          device="cpu")
    assert isinstance(offline, FraudAnalysisAgent)
    assert isinstance(offline.backend, CannedBackend)
    assert offline.temperature == pytest.approx(0.7)
    assert offline.pipeline.featurizer.num_features == 1024

    url_agent = build_agent(config, "OpenAI-compatible URL",
                            "http://localhost:9999/v1", temperature=0.2,
                            device="cpu")
    assert isinstance(url_agent.backend, OpenAIChatBackend)
    assert url_agent.backend.base_url.startswith("http://localhost:9999")

    no_key = build_agent(config, "DeepSeek API", "", temperature=1.0,
                         device="cpu")
    assert isinstance(no_key.backend, CannedBackend)


def test_monitor_thread_lifecycle(config):
    agent = build_agent(config, "Offline (no LLM)", "", temperature=1.0,
                        device="cpu")

    state = MonitorState(maxlen=50)
    start_monitor(state, agent, config, demo=True)
    assert state.thread is not None and state.thread.daemon

    deadline = time.time() + 30
    while time.time() < deadline and not state.snapshot(1):
        time.sleep(0.05)
    snap = state.snapshot(5)
    assert snap, "no classified messages reached the monitor tap"
    assert all({"prediction", "label"} <= set(p) for p in snap)
    assert len(snap) <= 5
    assert state.engine.stats.processed > 0

    state.engine.stop()
    state.thread.join(timeout=15)
    assert not state.thread.is_alive()

    state.engine = None
    start_monitor(state, agent, config, demo=True)
    state.engine.stop()
    state.thread.join(timeout=15)
    assert not state.thread.is_alive()


def test_main_full_drive_headless(config, monkeypatch):
    """main() end to end without streamlit: render, tab-1 analyze, tab-2
    batch CSV, tab-3 monitor start/stop, with the @cache_resource agent
    memo and session_state persisting across reruns."""
    import io

    import pandas as pd
    from fixtures import SCAM_DIALOGUE
    from test_ui_app import FakeStreamlit

    from fraud_detection_tpu_torch.app import ui

    fake = FakeStreamlit()
    monkeypatch.setattr(ui, "require_streamlit", lambda: fake)
    monkeypatch.delenv("KAFKA_BOOTSTRAP_SERVERS", raising=False)

    ui.main()
    assert any("Phone-Scam Detection" in t[0] for t in fake.of("title"))

    fake.rendered.clear()
    fake.script = {("text_area", "Dialogue transcript"): SCAM_DIALOGUE,
                   ("button", "Analyze"): True}
    n_cached = len(fake._resource_cache)
    ui.main()
    assert len(fake._resource_cache) == n_cached
    badges = [b for (b,) in fake.of("markdown") if "fraud-badge" in str(b)]
    assert badges, "no classification badge rendered"
    assert any(m[0] == "Confidence" for m in fake.of("metric"))
    assert fake.of("write"), "no LLM analysis rendered (canned backend)"

    fake.rendered.clear()
    csv = pd.DataFrame({"dialogue": [SCAM_DIALOGUE.replace("\n", " "),
                                     "hello confirming tomorrow"]}
                       ).to_csv(index=False)
    fake.script = {("file_uploader", "batch"): io.StringIO(csv),
                   ("button", "Predict Labels"): True}
    ui.main()
    dfs = fake.of("dataframe")
    assert dfs and len(dfs[0][0]) == 2
    assert set(dfs[0][0].columns) >= {"dialogue", "prediction", "label"}
    assert fake.of("download_button")

    fake.rendered.clear()
    fake.script = {("button", "Start Monitoring"): True}
    ui.main()
    monitor = fake.session_state.monitor
    assert monitor.engine is not None and monitor.thread.daemon
    deadline = time.time() + 30
    while time.time() < deadline and not monitor.snapshot(1):
        time.sleep(0.05)
    assert monitor.snapshot(1), "monitor tap never saw a classified message"

    fake.rendered.clear()
    fake.script = {("button", "Stop"): True}
    ui.main()
    assert fake.session_state.monitor.engine is None
    monitor.thread.join(timeout=15)
    assert not monitor.thread.is_alive()


def test_chat_main_headless(monkeypatch):
    from test_ui_app import FakeStreamlit

    from fraud_detection_tpu_torch.app import chat

    fake = FakeStreamlit()
    monkeypatch.setattr(chat, "require_streamlit", lambda: fake)
    calls = {}

    class StubBackend:
        def __init__(self, base_url, model, api_key=None):
            calls["built"] = (base_url, model, api_key)

        def chat(self, messages, temperature):
            calls["n_messages"] = len(messages)
            return "stub reply"

    monkeypatch.setattr(chat, "OpenAIChatBackend", StubBackend)

    fake.script = {("chat_input", "Say something"): "hello there"}
    chat.main()
    assert fake.session_state.messages == [
        {"role": "user", "content": "hello there"},
        {"role": "assistant", "content": "stub reply"}]
    assert calls["built"][0].startswith("http://localhost:1234")
    assert calls["n_messages"] == 1

    fake.script = {}
    chat.main()
    assert len(fake.session_state.messages) == 2

    class FailBackend(StubBackend):
        def chat(self, messages, temperature):
            raise chat.BackendError("endpoint down")

    monkeypatch.setattr(chat, "OpenAIChatBackend", FailBackend)
    fake.script = {("chat_input", "Say something"): "are you there?"}
    chat.main()
    assert fake.session_state.messages[-1]["content"].startswith(
        "[backend error:")


def test_main_via_apptest_when_streamlit_present(config):
    """A real-streamlit AppTest drive where streamlit exists; the headless
    drive above runs every tab where it does not."""
    import os

    streamlit = pytest.importorskip("streamlit")
    del streamlit
    from streamlit.testing.v1 import AppTest

    ui_path = os.path.join(os.path.dirname(__file__), "..",
                           "fraud_detection_tpu_torch", "app", "ui.py")
    at = AppTest.from_file(ui_path, default_timeout=60)
    at.run()
    assert not at.exception
    assert at.title and "Phone-Scam Detection" in at.title[0].value
