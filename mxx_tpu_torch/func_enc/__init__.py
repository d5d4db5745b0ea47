from .fe import (  # noqa: F401
    Aky24Ciphertext,
    Aky24FuncEnc,
    Aky24FuncKey,
    Aky24MasterKey,
    FuncEnc,
    NoCircuitEvaluator,
)
