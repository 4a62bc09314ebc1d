"""On-device LLM backend: explanations served from the card itself — twin
of ``fraud_detection_tpu/explain/onpod.py``.

``OnPodBackend`` adapts any ``generate_fn(prompt, temperature, max_tokens)
-> str`` (and optionally a batch variant) to the ``LLMBackend`` interface,
flattening chat history into one prompt the way small instruction-tuned
models expect. ``from_model`` binds it to this package's decoder
(``models/llm.py``), whose batched decode explains a whole flagged
micro-batch at once, and ``from_hf_checkpoint`` to a Hugging Face
checkpoint directory loaded by ``checkpoint/hf_convert.py`` (optionally
weight-only int8, tensor-parallel over a mesh).
``make_stream_explain_hook`` turns a backend into the streaming engine's
``explain_batch_fn``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from fraud_detection_tpu_torch.explain.backends import (ChatMessage,
                                                        _GenerateMixin,
                                                        frame_prompt)
from fraud_detection_tpu_torch.explain.prompts import analysis_prompt
from fraud_detection_tpu_torch.utils import get_logger


def flatten_chat(messages: Sequence[ChatMessage]) -> str:
    """Render a chat transcript as a single plain-text prompt."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        parts.append(f"<|{role}|>\n{m.get('content', '')}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


@dataclass
class OnPodBackend(_GenerateMixin):
    """LLMBackend over an in-process generation function."""

    generate_fn: Callable[[str, float, int], str]
    # Optional batch variant: prompts -> replies in ONE batched decode
    # (instead of one synchronous HTTPS call per message, the round trip is
    # amortized over a whole flagged batch). None = fall back to per-prompt
    # generate_fn.
    generate_batch_fn: Optional[Callable[[Sequence[str], float, int],
                                         Sequence[str]]] = None

    def chat(self, messages: Sequence[ChatMessage], *, temperature: float = 1.0,
             max_tokens: int = 1000) -> str:
        return self.generate_fn(flatten_chat(messages), temperature, max_tokens)

    def generate_batch(self, prompts: Sequence[str], *,
                       temperature: float = 0.0,
                       max_tokens: int = 256) -> Sequence[str]:
        """Explain many dialogues in one batched decode (uneven prompt
        lengths batched via models/llm.py ``generate_text_batch``).

        Framing parity with ``generate``: each prompt gets the same
        system-instruction + chat template the single path applies
        (``_GenerateMixin.generate`` -> ``chat`` -> ``flatten_chat``) — an
        instruction-tuned checkpoint must see identical inputs whether a
        batch or a single call produced them."""
        framed = [flatten_chat(frame_prompt(p)) for p in prompts]
        if self.generate_batch_fn is not None:
            return self.generate_batch_fn(framed, temperature, max_tokens)
        return [self.generate_fn(p, temperature, max_tokens) for p in framed]

    @classmethod
    def from_model(cls, lm, *, mesh=None) -> "OnPodBackend":
        """Bind to a models/llm.py ``LanguageModel`` (optionally sharded:
        its weights are already placed, so ``mesh`` is not read)."""
        def generate_fn(prompt: str, temperature: float, max_tokens: int) -> str:
            return lm.generate_text(prompt, temperature=temperature,
                                    max_new_tokens=max_tokens)

        def generate_batch_fn(prompts, temperature: float, max_tokens: int):
            # prompts arrive PRE-FRAMED by generate_batch
            return lm.generate_text_batch(prompts, temperature=temperature,
                                          max_new_tokens=max_tokens)

        return cls(generate_fn, generate_batch_fn)

    @classmethod
    def from_hf_checkpoint(cls, ckpt_dir: str, *, mesh=None,
                           max_seq: int = 4096, int8: bool = False,
                           tokenizer=None, device="cuda") -> "OnPodBackend":
        """Serve a locally downloaded HF checkpoint directory on the card,
        in place of the reference's hosted DeepSeek call
        (``checkpoint/hf_convert.py`` ``load_hf_checkpoint``). ``int8=True``
        loads it weight-only int8 (quantized on the host before the upload;
        the same weights as an after-load ``quantize_params``). ``mesh``:
        the weights tensor-parallel over its "model" axis (``device`` is not
        read); composes with ``int8``, whose leaves shard componentwise."""
        from fraud_detection_tpu_torch.checkpoint.hf_convert import (
            load_hf_checkpoint)

        return cls.from_model(load_hf_checkpoint(
            ckpt_dir, max_seq=max_seq, mesh=mesh, tokenizer=tokenizer,
            int8=int8, device=device), mesh=mesh)


def make_stream_explain_hook(backend, *, temperature: float = 0.0,
                             max_tokens: int = 128,
                             only_scams: bool = True):
    """Build a ``StreamingClassifier.explain_batch_fn`` from any backend
    with ``generate_batch`` (OnPodBackend, or a canned/test double).

    One backend call per micro-batch covers every row selected for
    explanation (default: predicted scams only — the reference's agent
    explains flagged dialogues, utils/agent_api.py:129-170, and spending
    decode budget on benign calls would throttle the stream for nothing).
    Backends without ``generate_batch`` (the HTTP clients, CannedBackend)
    fall back to one ``generate`` per selected row — still hook-shaped, just
    without the single-device-program amortization. Unselected rows get
    ``None`` so their output frames carry no "analysis" field. Row alignment
    is positional and length-checked by the engine.
    """
    log = get_logger("explain.hook")
    gen_batch = getattr(backend, "generate_batch", None)

    def explain_batch(texts, labels, confs):
        # "flagged" = any non-benign class: multiclass tree pipelines emit
        # labels >= 2 (engine supports them; label_name falls back to the
        # class id), and `lab == 1` would silently skip those rows.
        picked = [i for i, lab in enumerate(labels)
                  if (lab != 0 or not only_scams)]
        out = [None] * len(texts)
        if picked:
            prompts = [analysis_prompt(texts[i], labels[i], confs[i])
                       for i in picked]
            # Degraded mode everywhere below: a rate-limited/unreachable
            # backend must not halt CLASSIFICATION — messages go out
            # unannotated and the incident is logged (the reference's agent
            # likewise returns an error string instead of raising,
            # agent_api.py:57-63).
            if gen_batch is not None:
                try:
                    replies = gen_batch(prompts, temperature=temperature,
                                        max_tokens=max_tokens)
                except Exception as e:  # noqa: BLE001 — annotation only
                    log.warning("explanation backend failed for a %d-row "
                                "batch: %r", len(picked), e)
                    return out
                if len(replies) != len(picked):
                    # Same degraded mode as every other backend failure: a
                    # count mismatch is a backend bug, but raising here kills
                    # the engine's finish leg while the contract is
                    # "annotation only, classification never halts". zip
                    # would silently MISALIGN rows, so the whole batch goes
                    # out unannotated instead.
                    log.warning(
                        "explanation backend returned %d analyses for %d "
                        "prompts; dropping the batch's annotations",
                        len(replies), len(picked))
                    return out
                for i, reply in zip(picked, replies):
                    out[i] = reply
            else:
                # Per-row containment: one failed HTTPS call must not throw
                # away the analyses already paid for in this batch.
                for i, prompt in zip(picked, prompts):
                    try:
                        out[i] = backend.generate(prompt,
                                                  temperature=temperature,
                                                  max_tokens=max_tokens)
                    except Exception as e:  # noqa: BLE001 — annotation only
                        log.warning("explanation backend failed for row: %r", e)
        return out

    return explain_batch
