from .ring_gsw import (  # noqa: F401
    RingGswCiphertext,
    RingGswContext,
    native_decrypt_value,
    native_encrypt,
    native_gadget_row,
    sample_secret_key,
)
from .ckks import (  # noqa: F401
    CKKSCiphertext,
    CKKSContext,
)
