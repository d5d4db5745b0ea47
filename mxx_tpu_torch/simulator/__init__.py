from .norms import (  # noqa: F401
    PolyMatrixNorm,
    PolyNorm,
    SimulatorContext,
    compute_preimage_norm,
)
