from polyaxon_tpu_torch.streams.service import StreamsService

__all__ = ["StreamsService"]
