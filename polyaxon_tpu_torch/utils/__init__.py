"""Process utilities (port of ``polyaxon_tpu/utils``): retries with
backoff (``retries``) and the watchdog's interval loop (``watchloop``).

``utils/env.py`` has no counterpart. Its ``cpu_mesh_xla_flags``, the
libtpu probes and ``apply_jax_platforms_override`` set XLA's and JAX's
state, and the port's CPU gangs are gloo processes that need none of
it. Its one use with a meaning in the port, ``JAX_PLATFORMS=cpu plx
...``, is the port's CLI's explicit ``--device`` option on ``run``,
``server``, ``agent`` and ``serve`` (the card by default); the CLI reads
no environment variable that moves it to the CPU.
"""
