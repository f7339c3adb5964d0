"""The training runtime (port of ``polyaxon_tpu/runtime``): the job's
``runtime:`` config, optimizers and schedules, the train and eval
steps, the data streams, FLOPs accounting, the loop and its launcher.
One device, no sharding.
"""
