"""See the package docstring: twin of fraud_detection_tpu.app."""


def unported(what: str, item: int) -> SystemExit:
    """The exit of a CLI asked for something the port does not offer yet,
    naming the ROADMAP.md Queue 1 item that holds it."""
    return SystemExit(f"{what} is not ported to fraud_detection_tpu_torch "
                      f"yet (ROADMAP.md Queue 1 item {item})")
