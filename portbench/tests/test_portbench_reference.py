"""The plain references against the program's own plain CPU paths, at small
sizes: the served decoder's logits. The references
import nothing of the program; these tests import both."""

import pytest
import torch

import program
import weights
from reference.decoder import Decoder, token_gaps

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128,
            vocab_size=300, max_position_embeddings=512, rope_theta=10000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
            dtype="float32")


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_decoder_matches_the_program_forward(seed):
    from fraud_detection_tpu_torch.models.llm import forward
    cpu = torch.device("cpu")
    lm = program.language_model(TINY, weights.model_leaves(TINY, seed, cpu))
    toks = torch.randint(0, 258, (1, 40), generator=torch.Generator().manual_seed(1))
    want, _ = forward(lm.params, toks, lm.cfg)
    got = Decoder(TINY, seed, cpu).logits([toks[0]], [torch.arange(40)])[0]
    assert torch.allclose(got, want[0], atol=2e-4, rtol=1e-4)


def test_norm_gains_are_drawn_from_the_seed():
    cpu = torch.device("cpu")
    a, b, c = (weights.model_leaves(TINY, s, cpu) for s in (5, 5, 6))
    for name in ("l0.ln1", "l1.ln2", "ln_f"):
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
        assert 0.05 < float((a[name] - 1).std()) < 0.2


def test_control_precisions_move_the_logits():
    cpu = torch.device("cpu")
    toks = torch.arange(30) % 250
    pos = torch.arange(30)
    base = Decoder(TINY, 3, cpu, "f32").logits([toks], [pos])[0]
    low = Decoder(TINY, 3, cpu, "fp8").logits([toks], [pos])[0]
    assert (low - base).abs().max() > 1e-3
    gaps = token_gaps(base, low.argmax(-1))
    assert (gaps >= 0).all()
