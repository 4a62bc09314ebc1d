"""The port's ``utils/config.py`` against the JAX package's, on the CPU: the
twins of ``tests/test_utils.py``'s config cases, each run through both
packages on the same input and compared field for field (exact: parsing
has no tolerance)."""

import dataclasses

import pytest

from fraud_detection_tpu import utils as jutils
from fraud_detection_tpu_torch import utils as tutils

PKGS = pytest.mark.parametrize("u", [jutils, tutils], ids=["jax", "torch"])

ENV_TEXT = ("# comment\n"
            "DEEPSEEK_API_KEY=sk-abc123\n"
            'KAFKA_BOOTSTRAP_SERVERS="broker1:9092,broker2:9092"\n'
            "export KAFKA_INPUT_TOPIC=raw-topic\n"
            "QUOTED='with spaces'\n"
            "INLINE=value # trailing comment\n"
            "EMPTY=\n"
            "malformed line without equals ignored\n")


def test_exports_equal_jax():
    assert tutils.__all__ == jutils.__all__
    for name in ("KafkaConfig", "LLMConfig", "ServingConfig", "AppConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(tutils, name))]
                == [f.name for f in dataclasses.fields(getattr(jutils, name))])


@PKGS
def test_parse_env_file(tmp_path, u):
    f = tmp_path / ".env"
    f.write_text(ENV_TEXT)
    env = u.parse_env_file(f)
    assert env["DEEPSEEK_API_KEY"] == "sk-abc123"
    assert env["KAFKA_BOOTSTRAP_SERVERS"] == "broker1:9092,broker2:9092"
    assert env["KAFKA_INPUT_TOPIC"] == "raw-topic"
    assert env["QUOTED"] == "with spaces"
    assert env["INLINE"] == "value"
    assert env["EMPTY"] == ""
    assert "malformed" not in env
    assert env == (jutils if u is tutils else tutils).parse_env_file(f)


@PKGS
def test_parse_env_file_missing(tmp_path, u):
    assert u.parse_env_file(tmp_path / "nope.env") == {}


@PKGS
def test_load_dotenv_dual_paths_no_override(tmp_path, u):
    # The reference's two .env locations (root and utils/); an existing
    # variable wins.
    (tmp_path / ".env").write_text("A=root\nB=root\n")
    sub = tmp_path / "utils"
    sub.mkdir()
    (sub / ".env").write_text("B=utils\nC=utils\n")
    environ = {"A": "preexisting"}
    applied = u.load_dotenv([tmp_path / ".env", sub / ".env"], environ=environ)
    assert environ == {"A": "preexisting", "B": "root", "C": "utils"}
    assert applied == {"B": "root", "C": "utils"}
    over = {"A": "preexisting"}
    u.load_dotenv([tmp_path / ".env"], override=True, environ=over)
    assert over == {"A": "root", "B": "root"}


KAFKA_ENV = {
    "KAFKA_BOOTSTRAP_SERVERS": "k1:9092",
    "KAFKA_INPUT_TOPIC": "in",
    "KAFKA_OUTPUT_TOPIC": "out",
    "KAFKA_CONSUMER_GROUP": "grp",
    "KAFKA_SECURITY_PROTOCOL": "SASL_SSL",
    "KAFKA_USERNAME": "u",
    "KAFKA_PASSWORD": "p",
}


@PKGS
def test_kafka_config_from_env(u):
    c = u.KafkaConfig.from_env(KAFKA_ENV)
    assert c.bootstrap_servers == "k1:9092"
    assert c.security_protocol == "SASL_SSL"
    assert c.username == "u" and c.password == "p"


def test_kafka_config_equals_jax():
    for env in (KAFKA_ENV, {}, {"KAFKA_USERNAME": ""}):
        assert (dataclasses.asdict(tutils.KafkaConfig.from_env(env))
                == dataclasses.asdict(jutils.KafkaConfig.from_env(env)))


@PKGS
def test_kafka_config_defaults_match_reference(u):
    c = u.KafkaConfig.from_env({})
    assert c.bootstrap_servers == "localhost:9092"
    assert c.input_topic == "customer-dialogues-raw"
    assert c.output_topic == "dialogues-classified"
    assert c.consumer_group == "dialogue-classifier-group"
    assert c.security_protocol is None


@PKGS
def test_llm_config_and_backend(u):
    c = u.LLMConfig.from_env({"DEEPSEEK_API_KEY": "sk-x",
                              "LLM_TEMPERATURE": "0.3"})
    assert c.api_key == "sk-x"
    assert c.base_url == "https://api.deepseek.com/v1"
    assert c.model == "deepseek-chat"
    assert c.temperature == 0.3
    be = c.make_backend(transport=lambda *a, **k: None)
    assert be.api_key == "sk-x" and be.timeout == 90.0 and be.max_attempts == 3


@PKGS
def test_app_config_aggregates(u):
    cfg = u.AppConfig.from_env({"FRAUD_BATCH_SIZE": "64",
                                "FRAUD_MAX_WAIT": "0.2"})
    assert cfg.serving.batch_size == 64
    assert cfg.serving.max_wait == 0.2
    assert cfg.kafka.input_topic == "customer-dialogues-raw"


def test_app_config_equals_jax(tmp_path, monkeypatch):
    env = {**KAFKA_ENV, "FRAUD_MODEL_PATH": "m", "FRAUD_BATCH_SIZE": "32",
           "LLM_TIMEOUT": "12", "LLM_MAX_ATTEMPTS": "5"}
    t = dataclasses.asdict(tutils.AppConfig.from_env(env))
    j = dataclasses.asdict(jutils.AppConfig.from_env(env))
    assert t == j
    # dotenv_paths load into the process environment first
    (tmp_path / ".env").write_text("FRAUD_MAX_WAIT=0.7\n")
    # setenv first, so teardown restores the variable's original state
    monkeypatch.setenv("FRAUD_MAX_WAIT", "0")
    monkeypatch.delenv("FRAUD_MAX_WAIT")
    got = tutils.AppConfig.from_env(dotenv_paths=[str(tmp_path / ".env")])
    assert got.serving.max_wait == 0.7
