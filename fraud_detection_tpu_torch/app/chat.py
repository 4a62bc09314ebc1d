"""Standalone chat UI for any OpenAI-compatible endpoint — twin of
``fraud_detection_tpu/app/chat.py``: the endpoint, model and temperature are
set in the sidebar, and the transport is the port's ``OpenAIChatBackend``,
the same client the explanation agent uses.

Run:  streamlit run fraud_detection_tpu_torch/app/chat.py
"""

from __future__ import annotations

from fraud_detection_tpu_torch.app.ui_helpers import require_streamlit
from fraud_detection_tpu_torch.explain import BackendError, OpenAIChatBackend


def main() -> None:  # pragma: no cover - drives streamlit
    st = require_streamlit()
    st.set_page_config(page_title="LLM Chat", layout="centered")
    st.title("Chat")

    with st.sidebar:
        base_url = st.text_input("Endpoint", "http://localhost:1234/v1")
        model = st.text_input("Model", "local-model")
        api_key = st.text_input("API key (optional)", type="password")
        temperature = st.slider("Temperature", 0.0, 1.5, 0.7, 0.1)
        if st.button("Clear history"):
            st.session_state.messages = []

    backend = OpenAIChatBackend(base_url=base_url, model=model,
                                api_key=api_key or None)
    if "messages" not in st.session_state:
        st.session_state.messages = []

    for msg in st.session_state.messages:
        with st.chat_message(msg["role"]):
            st.write(msg["content"])

    if prompt := st.chat_input("Say something"):
        st.session_state.messages.append({"role": "user", "content": prompt})
        with st.chat_message("user"):
            st.write(prompt)
        try:
            reply = backend.chat(st.session_state.messages,
                                 temperature=temperature)
        except BackendError as exc:
            reply = f"[backend error: {exc}]"
        st.session_state.messages.append({"role": "assistant", "content": reply})
        with st.chat_message("assistant"):
            st.write(reply)


if __name__ == "__main__":
    main()
