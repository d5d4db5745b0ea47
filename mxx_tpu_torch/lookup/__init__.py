from .debug import (  # noqa: F401
    DebugBGGEncodingPltEvaluator,
    DebugBGGPubKeyPltEvaluator,
    RelationCheckingPltEvaluator,
    debug_trapdoor_preimage,
)
from .lwe import LWEBGGEncodingPltEvaluator, LWEBGGPubKeyPltEvaluator, set_plt_context  # noqa: F401
from .poly_eval import PolyPltEvaluator  # noqa: F401
from .public_lut import PublicLut  # noqa: F401
