from .evaluators import (  # noqa: F401
    BGGVecSlotTransferEvaluator,
    PolyVecSlotTransferEvaluator,
)
