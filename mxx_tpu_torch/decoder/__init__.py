from .artifact import (  # noqa: F401
    DirectoryDecoderArtifacts,
    InMemoryDecoderArtifacts,
    VecDecoderArtifacts,
)
from .masked_high_bit import (  # noqa: F401
    MaskedHighBitDecoder,
    decode_centered_masked_boolean_coeff,
    decode_centered_masked_integer_coeff,
    decode_centered_masked_matrix,
)
