"""Serving runtime of the port: paged continuous batching over HTTP.

Import ``serving.server`` / ``serving.batching`` directly; this package
init imports nothing so that ``python -m polyaxon_tpu_torch.serving``
and the tests stay light.
"""
