"""Score dialogues with the shipped reference model (or a synthetic one) on
the PyTorch port — twin of ``examples/serve_quickstart.py``.

Run:  python examples/torch_serve_quickstart.py [--device cpu]

The pipeline runs on the card unless ``--device cpu`` is given. It
featurizes on the host, as the JAX example does, so it launches no kernel.

Where the JAX example looks for the shipped Spark artifact at a fixed
path, the twin serves it only from the directory that
``FRAUD_TPU_SPARK_ARTIFACT`` names; unset, it trains the synthetic demo
model, as the JAX example does when its artifact is absent.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the shipped Spark artifact's directory, named by the caller
ARTIFACT_ENV = "FRAUD_TPU_SPARK_ARTIFACT"

SCAM = (
    "Agent: Congratulations! You have been selected as the winner of our "
    "grand prize. To process your prize payment immediately we just need "
    "you to verify your social security number and bank account details. "
    "This is urgent - the offer expires today. Customer: Oh wow, really? "
    "Agent: Yes! Please confirm your account number now to claim it."
) * 3
BENIGN = (
    "Agent: Good morning, this is the dental office calling to confirm "
    "your cleaning appointment on Thursday at two thirty. Customer: Yes, "
    "that works for me, thank you for the reminder. Agent: Great, we will "
    "see you then. Have a nice day."
) * 3


def build_pipeline(batch_size: int = 16, device: str = "cuda"):
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    artifact = os.environ.get(ARTIFACT_ENV)
    if artifact:
        from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
            load_spark_pipeline)

        print("using the shipped Spark artifact (F1-parity weights)")
        return ServingPipeline.from_spark_artifact(
            load_spark_pipeline(artifact), batch_size=batch_size,
            device=device)
    from fraud_detection_tpu_torch.models.pipeline import synthetic_demo_pipeline

    print("reference artifact not found; training a synthetic demo model")
    return synthetic_demo_pipeline(batch_size=batch_size, device=device)


def device_arg(ap: argparse.ArgumentParser) -> None:
    """The twins' one flag of their own: where the port runs."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain torch versions)")


def run(argv=None) -> dict:
    """Score the two dialogues; returns each one's (label, p) and the exit
    code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    pipe = build_pipeline(device=args.device)
    scored = {}
    for name, text in [("scam-like", SCAM), ("benign", BENIGN)]:
        label, p = pipe.predict_one(text)
        print(f"{name:10s} -> prediction={label}  p(scam)={float(p):.6f}")
        scored[name] = (int(label), float(p))
    return {"scored": scored, "exit_code": 0}


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
