from .nested_rns import (  # noqa: F401
    NestedRnsPoly,
    NestedRnsPolyContext,
    decode_nested_rns_outputs,
    encode_nested_rns_value,
    sample_crt_primes,
)
from .carry_montgomery import (  # noqa: F401
    CarryArithContext,
    CarryArithPoly,
    MontgomeryContext,
)
