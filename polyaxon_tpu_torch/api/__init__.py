from polyaxon_tpu_torch.api.server import ApiServer

__all__ = ["ApiServer"]
