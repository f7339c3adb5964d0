"""Model families ported from ``polyaxon_tpu.models`` (llama so far)."""
