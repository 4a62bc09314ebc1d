"""Trace conformance for the fleet's control lane — the part of
``fraud_detection_tpu.analysis`` (flightcheck) that the game days need:
``conformance`` replays a recorded control-lane journal against the
declared role machines (``entrypoints.FLEET_PROTOCOLS``). The linters, the
model checker and the thread map are not ported yet (ROADMAP.md Queue 1
item 8).
"""
