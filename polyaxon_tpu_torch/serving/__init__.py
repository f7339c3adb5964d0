"""Serving runtime of the port: the static and continuous engines over HTTP,
speculation, int8 weights, request traces and the fleet.

Import ``serving.server`` / ``serving.batching`` directly; this package
init imports nothing so that ``python -m polyaxon_tpu_torch.serving``
and the tests stay light.
"""
