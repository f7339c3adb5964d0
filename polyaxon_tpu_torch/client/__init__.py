from polyaxon_tpu_torch.client.client import ApiClientError, PolyaxonClient, RunClient

__all__ = ["ApiClientError", "PolyaxonClient", "RunClient"]
