from polyaxon_tpu_torch.fs.store import (
    FsspecStore,
    LocalStore,
    MemoryStore,
    Store,
    StoreError,
    TransientStoreError,
    get_store,
    is_transient_store_error,
    register_store,
)

__all__ = [
    "FsspecStore",
    "LocalStore",
    "MemoryStore",
    "Store",
    "StoreError",
    "TransientStoreError",
    "get_store",
    "is_transient_store_error",
    "register_store",
]
