from .norms import (  # noqa: F401
    ErrorNorm,
    NormPltLWEEvaluator,
    PolyMatrixNorm,
    PolyNorm,
    SimulatorContext,
    bits_ceil,
    compute_preimage_norm,
    simulate_max_error_norm,
)
from .plt_norms import NormPltCommitEvaluator, NormPltGGH15Evaluator  # noqa: F401
from .lattice_estimator import (  # noqa: F401
    LweDistSpec,
    heuristic_security_bits,
    run_lattice_estimator_cli,
)
from .eval_error import (  # noqa: F401
    AffineCircuitEvaluator,
    AffineErrorNormExpr,
    AffineLWEWrapper,
    ErrorNormSummaryExpr,
    simulate_max_error_norm_affine,
)
