"""Process utilities (port of ``polyaxon_tpu/utils``): retries with
backoff (``retries``) and the watchdog's interval loop (``watchloop``)."""
