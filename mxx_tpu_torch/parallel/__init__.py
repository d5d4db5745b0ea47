from .crt_collective import crt_switch_sharded  # noqa: F401
from .mesh import (  # noqa: F401
    COL_AXIS,
    LIMB_AXIS,
    Mesh,
    Sharding,
    factor_devices,
    make_mesh,
    matrix_sharding,
    replicated,
    table_sharding,
)
