from .store import (  # noqa: F401
    BatchLookupBuffer,
    StorageSystem,
    add_lookup_buffer,
    get_lookup_buffer,
    get_lookup_buffer_stacked,
    get_lookup_buffer_bytes,
    get_storage_system,
    init_storage_system,
    read_bytes_from_multi_batch,
    read_matrices_from_multi_batch,
    read_matrix_from_multi_batch,
    wait_for_all_writes,
)
